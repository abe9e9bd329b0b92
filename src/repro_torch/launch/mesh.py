"""Cohort meshes of the port (the torch analogue of
``repro.launch.mesh``'s ``make_cohort_mesh`` and ``make_host_mesh``).

The reference's mesh is a grid of the devices one JAX process drives.
The port runs one process per rank, so its mesh is this process's place
in the ``torch.distributed`` group: the group, this rank, the world size
(the ``data`` axis: one cohort slice per rank), the ``model`` axis (1:
nothing in the port shards a model yet) and the device the rank
computes on.  ``MeshAxes.from_mesh`` reads it as it reads a JAX mesh
(``axis_names``, ``shape``).  Without an initialized group (or asked for
one rank) it is a world of 1, like the reference's one-device mesh.
The production meshes (256 / 512 chips) are the XLA launch tooling's and
are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class CohortMesh:
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    rank: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    group: Any = None           # the process group (None: a world of 1)

    @property
    def world(self) -> int:
        """Ranks on the ``data`` axis (the cohort is split over them)."""
        return self.shape["data"]


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("a mesh was asked for a CUDA card and none is "
                               "present; pass device='cpu' to run on the CPU")
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def _group_mesh(names, n: Optional[int], device, model: bool):
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n is not None and n not in (1, world):
        raise ValueError(f"a cohort mesh of {n} ranks in a world of {world}: "
                         "the port meshes the whole group or one rank")
    size = world if n is None else n
    shape = {"data": size}
    if model:
        shape["model"] = 1
    return CohortMesh(names, shape,
                      rank=dist.get_rank() if size > 1 else 0,
                      device=_device(device),
                      group=dist.group.WORLD if size > 1 else None)


def make_cohort_mesh(n: Optional[int] = None, *, device="cuda"):
    """1-D ``(data,)`` mesh for cohort-sharded AdaSplit training
    (``shard_clients=True``): the stacked client axis C is split over the
    group's ranks, C/world clients a rank.  ``n``: None (the whole group)
    or 1 (this rank alone, the no-op the reference's one-device mesh
    gives)."""
    return _group_mesh(("data",), n, device, model=False)


def make_host_mesh(*, device="cuda"):
    """The group as a (data, model) mesh with model = 1: the execution
    mesh of the examples and smoke runs."""
    return _group_mesh(("data", "model"), None, device, model=True)
