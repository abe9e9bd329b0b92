"""Multi-process bootstrap of the port (the torch analogue of
``repro.launch.distributed``).

The reference runs every device of a host from one JAX process; the port
runs one process per rank and joins them with ``torch.distributed``.
``initialize`` wires the ranks into one process group, from its
arguments, from the reference's variables (``REPRO_COORDINATOR`` =
``host:port`` or an ``init_method`` URL, ``REPRO_NUM_PROCESSES``,
``REPRO_PROCESS_ID``) or from ``torchrun``'s (``MASTER_ADDR``,
``WORLD_SIZE``, ``RANK``).  The backend is always the caller's choice:
``nccl`` where each rank has a card of its own, ``gloo`` where ranks
share one card (NCCL refuses two ranks on one device) or run on the CPU;
``choose_backend`` states that rule, and nothing here falls back from one
backend to the other.

``run_ranks`` starts ``world`` ranks of a function as spawned processes
(a parent that holds a CUDA context cannot fork), rendezvousing through
a ``file://`` store in a fresh directory, bounds the whole job by a
timeout, and returns each rank's result or raises with the ranks'
tracebacks.  Nothing is imported or initialized at module import.
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

BACKENDS = ("gloo", "nccl")
DEFAULT_TIMEOUT_S = 300.0


def choose_backend(device, world: int) -> str:
    """The backend for ``world`` ranks on ``device``: ``nccl`` when every
    rank can have a card of its own, ``gloo`` when they run on the CPU or
    more ranks than cards share the host's cards."""
    device = torch.device(device)
    if device.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _env_int(*names) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, backend: str,
               timeout: float = DEFAULT_TIMEOUT_S) -> bool:
    """Idempotent multi-process init; returns whether this call joined a
    group.

    coordinator    ``"host:port"`` (a TCP rendezvous) or an
                   ``init_method`` URL (``tcp://...``, ``file://...``);
                   else ``REPRO_COORDINATOR``; else ``env://`` when
                   ``torchrun``'s ``MASTER_ADDR`` is set; else nothing
                   to join: a world of one process, as the reference's
                   single-process environments
    num_processes  else ``REPRO_NUM_PROCESSES``, else ``WORLD_SIZE``
    process_id     else ``REPRO_PROCESS_ID``, else ``RANK``
    backend        ``"gloo"`` or ``"nccl"`` (see :func:`choose_backend`)
    timeout        seconds any collective may wait before it raises

    Under ``nccl`` the rank takes card ``LOCAL_RANK`` (else its rank)
    modulo the host's cards."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not "
                         f"{backend!r}")
    if dist.is_initialized():
        return False
    coordinator = coordinator or os.environ.get("REPRO_COORDINATOR")
    if coordinator:
        init_method = coordinator if "://" in coordinator \
            else f"tcp://{coordinator}"
    elif os.environ.get("MASTER_ADDR"):
        init_method = "env://"
    else:
        return False
    world = num_processes if num_processes is not None \
        else _env_int("REPRO_NUM_PROCESSES", "WORLD_SIZE")
    rank = process_id if process_id is not None \
        else _env_int("REPRO_PROCESS_ID", "RANK")
    if world is None or rank is None:
        raise ValueError("a rendezvous needs the number of processes and "
                         "this process's id (arguments, REPRO_NUM_PROCESSES "
                         "/ REPRO_PROCESS_ID, or WORLD_SIZE / RANK)")
    if backend == "nccl":
        local = _env_int("LOCAL_RANK")
        torch.cuda.set_device((rank if local is None else local)
                              % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    return True


def shutdown():
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def describe() -> dict:
    """This process's place in the job (the reference's keys, plus the
    backend)."""
    joined = dist.is_initialized()
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    world = dist.get_world_size() if joined else 1
    return {"process_index": dist.get_rank() if joined else 0,
            "process_count": world,
            "local_devices": max(cards, 1),
            "global_devices": world,
            "platform": "cuda" if cards else "cpu",
            "backend": dist.get_backend() if joined else None}


# ---------------------------------------------------------------------------
# a job of ranks started from one parent process
# ---------------------------------------------------------------------------


def _rank_main(fn, args, rank: int, world: int, backend: str,
               init_method: str, timeout: float, out_dir: str):
    """One spawned rank: join the group, run ``fn(*args)``, write its
    result (or its traceback) to ``out_dir``, leave the group."""
    path = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        initialize(init_method, world, rank, backend=backend,
                   timeout=timeout)
        out = ("ok", fn(*args))
    except Exception:                           # reported to the parent
        out = ("error", traceback.format_exc())
    try:
        with open(path + ".tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(path + ".tmp", path)
    finally:
        shutdown()


def run_ranks(fn: Callable, world: int, *, backend: str,
              args: Sequence[Any] = (),
              timeout: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` spawned ranks joined in one group
    (``file://`` rendezvous in a fresh temporary directory) and return
    their results in rank order.  ``fn`` and ``args`` must pickle (``fn`` a
    module-level function of a module the ranks can import).

    The whole job is bounded by ``timeout`` seconds (each collective in
    the ranks too): past it every rank still running is killed and
    ``TimeoutError`` names them.  A rank that raises or dies makes this
    raise ``RuntimeError`` with each rank's traceback or exit code."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    out_dir = tempfile.mkdtemp(prefix="repro_ranks_")
    init = "file://" + os.path.join(out_dir, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, tuple(args), r, world, backend, init,
                               timeout, out_dir), daemon=True)
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
        late = [r for r, p in enumerate(procs) if p.is_alive()]
        for r in late:
            procs[r].kill()
            procs[r].join(10)
        results, errors = [], []
        for r, p in enumerate(procs):
            path = os.path.join(out_dir, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r}: no result (exit code "
                              f"{p.exitcode})")
                results.append(None)
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                errors.append(f"rank {r} raised:\n{value}")
            results.append(value)
        if late:
            raise TimeoutError(f"ranks {late} of {world} still ran after "
                               f"{timeout} s and were killed\n"
                               + "\n".join(errors))
        if errors:
            raise RuntimeError("\n".join(errors))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        shutil.rmtree(out_dir, ignore_errors=True)
