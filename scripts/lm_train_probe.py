#!/usr/bin/env python3
"""The LM trainer alone on one CUDA card: the host syncs of its steps,
with the stack of each, then ``chip_smoke.py``'s phase 8b by itself.

    python3 scripts/lm_train_probe.py

It builds the kernels, runs four steps of ``LMAdaSplitTrainer`` on
qwen2-0.5b at chip_smoke's phase 8b configuration (full width, C=4,
B=16, S=128; two local and two global steps, one window) under
``torch.cuda.set_sync_debug_mode("warn")``, and prints each distinct
place that synchronised (the trainer's one fetch is the only one
expected), then calls ``chip_smoke.lm_trainer_phase`` and prints its
wall time.  The card's name and power limit come first.
"""
from __future__ import annotations

import subprocess
import sys
import time
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main() -> int:
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    print(sys.version, torch.__version__, torch.version.cuda)
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.weights import strict_fp32
    strict_fp32()
    t0 = time.time()
    _build.build_all()
    print(f"build {time.time() - t0:.2f} s")
    cfg = get_config(cs.SERVE_ARCH)
    shape, policy = cs.lm_train_setup(cfg)
    tr = cs.lm_trainer(cfg, shape, policy)
    torch.cuda.synchronize()
    seen = []

    def show(msg, cat, fn, ln, file=None, line=None):
        stack = "".join(traceback.format_stack(limit=14)[:-2])
        if stack[-600:] not in seen:
            seen.append(stack[-600:])
            print("SYNC WARNING:", msg, "\n", stack)
    shown = warnings.showwarning
    warnings.showwarning = show
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            tr.run(4, log_every=4)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        warnings.showwarning = shown
    print(f"distinct sync sites: {len(seen)}")
    print(tr.history)
    del tr
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.time()
    print(cs.lm_trainer_phase(gen, cfg))
    print(f"phase 8b wall {time.time() - t0:.2f} s")
    print(f"profiler sessions: {cs.MARKERS_LOST}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
