#!/usr/bin/env python3
"""Host time per call of the port's flash-attention and panel-GEMM
wrappers on one CUDA card, for the ``repro_torch`` package under SRC.

    python3 scripts/wrapper_host_us.py [SRC]

SRC defaults to this checkout's ``src``.  To compare two checkouts, run
it for each in turn in one session on one machine (A, B, B, A): the
host clock of a shared machine drifts between processes.  Each wrapper
is timed three times with ``chip_smoke.host_us`` (the median of 50
calls issued back to back) at the serving session's flash shape
(B=8, S=512, 14/2 heads of 64, bf16, causal) and at two LeNet GEMMs
(server block 4 and the client block); the last line is one JSON
object of those readings in microseconds.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    src = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else ROOT / "src"
    sys.path.insert(0, str(src))
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from repro_torch.kernels import client_conv, flash_attention

    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v = (torch.randn((8, 512, h, 64), device="cuda", generator=gen)
               .to(torch.bfloat16).transpose(1, 2) for h in (14, 2, 2))
    gemms = {"gemm_server_block4": (1, 2432, 1600, 64),
             "gemm_client_block": (32, 32768, 75, 6)}
    ab = {name: (torch.randn((C, M, K), device="cuda", generator=gen),
                 torch.randn((C, K, N), device="cuda", generator=gen))
          for name, (C, M, K, N) in gemms.items()}
    out = {"src": str(src), "flash_session": []}
    out.update({name: [] for name in gemms})
    for _ in range(3):
        out["flash_session"].append(chip_smoke.host_us(
            lambda: flash_attention.flash_attention_cuda(q, k, v)))
        for name, (a, b) in ab.items():
            out[name].append(chip_smoke.host_us(
                lambda: client_conv.panel_gemm_cuda(a, b)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
