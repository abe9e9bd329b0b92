#!/usr/bin/env python3
"""Named parts of ``chip_smoke.py`` alone on one CUDA card.

    python3 scripts/probe.py PART [PART ...]

It builds the kernels, sets strict fp32, then runs each PART in the
order given and prints its wall time; the card's name and power limit
come first.  A group name stands for its parts in order.

PARTs:

- ``lm-train``: the LM trainer's host syncs, with the stack of each
  (four steps of qwen2-0.5b at phase 8b's configuration under
  ``torch.cuda.set_sync_debug_mode("warn")``; the trainer's one fetch
  is the only one expected), then phase 8b.
- ``ssm-flash``: the flash kernel at jamba's prefill shapes (its
  16-layer session in bf16, its reduced config in f32).
- ``ssm-two``: phase 6's mamba2-370m (2 layers) and reduced jamba, card
  against CPU, and one train step of the reduced deepseek-moe-16b and
  mamba2-370m likewise.
- ``ssm-serve``, ``ssm-train``: phases 7d and 8c.
- ``mm-flash``: the flash kernel at phase 7e's prefill shapes and phase
  6's multimodal f32 ones (``chip_smoke.mm_flash_cases``).
- ``mm-two``: phase 6's qwen2-vl-72b and seamless-m4t-large-v2 at 2
  layers (2 + 2), card against CPU.
- ``vlm``, ``encdec``: phase 7e's two halves; ``mm-train``: phase 8d.

Groups: ``ssm`` (the four ``ssm-`` parts), ``mm`` (``mm-flash``,
``mm-two``, ``vlm``, ``encdec``, ``mm-train``).
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


def lm_train(cs, gen):
    import torch
    from repro_torch.configs.base import get_config
    cfg = get_config(cs.SERVE_ARCH)
    tr = cs.lm_trainer(cfg, *cs.lm_train_setup(cfg))
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
    print(cs.lm_trainer_phase(gen, cfg))


def ssm_two(cs, gen):
    cs.lm_on_two_devices("mamba2-370m")
    cs.lm_on_two_devices(cs.SSM_ARCHS[1], cs.jamba_reduced())
    for arch in ("deepseek-moe-16b", "mamba2-370m"):
        cs.train_step_on_two_devices(arch)


PARTS = {
    "lm-train": lm_train,
    "ssm-flash": lambda cs, gen: cs.check_flash(cs.ssm_flash_cases(), gen),
    "ssm-two": ssm_two,
    "ssm-serve": lambda cs, gen: print(
        f"flash launches {cs.ssm_serving_phase()}"),
    "ssm-train": lambda cs, gen: print(cs.moe_ssm_trainer_phase(gen)),
    "mm-flash": lambda cs, gen: cs.check_flash(cs.mm_flash_cases(), gen),
    "mm-two": lambda cs, gen: cs.mm_on_two_devices(),
    "vlm": lambda cs, gen: print(f"flash launches {cs.vlm_serving_phase()}"),
    "encdec": lambda cs, gen: print(
        f"flash launches {cs.encdec_serving_phase()}"),
    "mm-train": lambda cs, gen: print(cs.encdec_trainer_phase(gen)),
}
GROUPS = {"ssm": ["ssm-flash", "ssm-two", "ssm-serve", "ssm-train"],
          "mm": ["mm-flash", "mm-two", "vlm", "encdec", "mm-train"]}


def main(argv) -> int:
    parts = [p for a in argv for p in GROUPS.get(a, [a])]
    unknown = [p for p in parts if p not in PARTS]
    if not parts or unknown:
        print(f"usage: probe.py PART [PART ...]; PARTs {sorted(PARTS)}, "
              f"groups {sorted(GROUPS)}; unknown {unknown}", file=sys.stderr)
        return 2
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    cs.SMI = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(cs.SMI)
    print(sys.version, torch.__version__, torch.version.cuda)
    from repro_torch.kernels import _build
    from repro_torch.weights import strict_fp32
    strict_fp32()
    t0 = time.time()
    _build.build_all()
    print(f"build {time.time() - t0:.2f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    for part in parts:
        t0 = time.time()
        PARTS[part](cs, gen)
        torch.cuda.empty_cache()
        print(f"{part} wall {time.time() - t0:.2f} s")
    print(f"profiler sessions: {cs.MARKERS_LOST}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
