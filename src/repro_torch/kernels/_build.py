"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/repro_torch_kernels/<name>-<hash>.so`` under the repository
root (``build/`` is git-ignored), at first use: ``load(name)`` builds
every source that is not built yet, all nvcc processes started together,
and caches the library by the hash of its source and flags.  Nothing is
built or imported at module import, so the CPU tests import freely.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
          "-Xptxas", "-v"]
# per-source extra flags: the Adam step rounds every multiply and add
# separately, as the plain fp32 version does
EXTRA = {"masked_adam": ["-fmad=false"], "panel_gemm": [],
         "flash_attention": [], "ntxent": [], "soft_threshold": []}

_libs: Dict[str, ctypes.CDLL] = {}
build_log: Dict[str, str] = {}
_sm_counts: Dict[int, int] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return nvcc


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join(ARCH + COMMON + EXTRA[name]).encode()
    digest = hashlib.sha256(src + flags).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all() -> Dict[str, float]:
    """Compile every source whose library is missing, in parallel.
    Returns the wall seconds of the build (0.0 when all were cached)."""
    todo = {n: _target(n) for n in EXTRA if not _target(n).exists()}
    if not todo:
        return {"seconds": 0.0}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH, *COMMON, *EXTRA[name], "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        build_log[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)        # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {"seconds": time.perf_counter() - t0}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    if name not in _libs:
        path = _target(name)
        if not path.exists():
            build_all()
        _libs[name] = ctypes.CDLL(str(path))
    return _libs[name]


def check(err: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: launch failed with cudaError_t {err}")


def sm_count(device) -> int:
    """Streaming multiprocessors of a CUDA device (grid-stride caps)."""
    import torch
    if device.index not in _sm_counts:
        _sm_counts[device.index] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _sm_counts[device.index]
