#!/usr/bin/env python3
"""The SSM, hybrid and MoE-training phases of ``chip_smoke.py`` alone on
one CUDA card.

    python3 scripts/ssm_probe.py [PART ...]

PARTs (all by default, in this order): ``flash`` (the flash kernel at
jamba's prefill shapes: its 16-layer session in bf16 and its reduced
config in f32, phase 5's check), ``two`` (phase 6's additions:
mamba2-370m at 2 layers and the reduced jamba, card against CPU in
strict fp32, and one train step of the reduced deepseek-moe-16b and
mamba2-370m likewise), ``serve`` (phase 7d) and ``train`` (phase 8c).
The card's name and power limit come first; each part prints its wall
time.
"""
from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))


def main(argv) -> int:
    import dataclasses
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
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.weights import strict_fp32
    strict_fp32()
    t0 = time.time()
    _build.build_all()
    print(f"build {time.time() - t0:.2f} s")
    parts = argv or ["flash", "two", "serve", "train"]
    gen = torch.Generator(device="cuda").manual_seed(0)
    jamba = "jamba-v0.1-52b"
    reduced = dataclasses.replace(get_config(jamba).reduced(),
                                  dtype="float32")
    for part in parts:
        t0 = time.time()
        if part == "flash":
            cases = cs.flash_cases(cs.ssm_cfg(jamba), cs.ssm_runs(jamba), [],
                                   jamba + " ")
            cases += [(reduced, f"{jamba} reduced {sh[0]}") + sh[1:]
                      + (torch.float32,) for sh in [cs.two_device_shape()]]
            cs.check_flash(cases, gen)
        elif part == "two":
            cs.lm_on_two_devices("mamba2-370m")
            cs.lm_on_two_devices(jamba, reduced)
            for arch in ("deepseek-moe-16b", "mamba2-370m"):
                cs.train_step_on_two_devices(arch)
        elif part == "serve":
            print(f"flash launches {cs.ssm_serving_phase()}")
        elif part == "train":
            print(cs.moe_ssm_trainer_phase(gen))
        else:
            raise SystemExit(f"unknown part {part!r}")
        torch.cuda.empty_cache()
        print(f"{part} wall {time.time() - t0:.2f} s")
    print(f"profiler sessions: {cs.MARKERS_LOST}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
