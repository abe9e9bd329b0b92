"""Config system of the port: the ``ModelConfig`` fields the LeNet path
reads, and the registry.

A copy of the reference's ``configs/base.py`` cut to the conv backbone;
the transformer fields arrive with the LM slice.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    source: str
    d_model: int = 0
    # conv/classification backbone (the paper's own model)
    is_conv: bool = False
    image_size: int = 32
    n_classes: int = 10
    conv_channels: Tuple[int, ...] = ()
    # AdaSplit split point: fraction of layers on the client
    mu: float = 0.2


_REGISTRY: Dict[str, ModelConfig] = {}

ARCH_MODULES = ["lenet_cifar"]


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        for m in ARCH_MODULES:
            importlib.import_module(f"repro_torch.configs.{m}")
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]
