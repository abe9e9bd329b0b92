"""Procedural stand-ins for the paper's datasets (offline container).

Two protocols mirroring AdaSplit §4.1:

* ``mixed_cifar``  — ONE generative 10-class image distribution; client i
  holds 2 distinct classes (low, consistent inter-client heterogeneity).
* ``mixed_noniid`` — FIVE distinct generative distributions (stand-ins
  for MNIST/CIFAR10/FMNIST/CIFAR100/NotMNIST); client i holds dataset i
  (high, variable pairwise heterogeneity).

Each pseudo-dataset draws per-class low-frequency prototypes (random 8x8
patterns bilinearly upsampled to 32x32x3) plus dataset-specific noise —
learnable by a LeNet within a few epochs, like the real thing at this
scale.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Tuple

import numpy as np


@dataclass
class ClientData:
    x: np.ndarray        # (N, 32, 32, 3) float32 in [0, 1]
    y: np.ndarray        # (N,) int32
    test_x: np.ndarray
    test_y: np.ndarray
    dataset_id: int = 0


def _prototypes(rng, n_classes, image_size, base_freq=8):
    protos = rng.normal(0, 1, (n_classes, base_freq, base_freq, 3))
    reps = image_size // base_freq
    protos = protos.repeat(reps, axis=1).repeat(reps, axis=2)
    # cheap smoothing
    protos = (protos + np.roll(protos, 1, 1) + np.roll(protos, 1, 2)) / 3
    protos = (protos - protos.min()) / (np.ptp(protos) + 1e-8)
    return protos.astype(np.float32)


def _sample(rng, protos, n, noise):
    n_classes = protos.shape[0]
    y = rng.integers(0, n_classes, n)
    x = protos[y] + rng.normal(0, noise, (n,) + protos.shape[1:])
    return np.clip(x, 0, 1).astype(np.float32), y.astype(np.int32)


def _make_dataset(seed, n_train, n_test, n_classes=10, image_size=32,
                  noise=0.25, class_subset=None):
    rng = np.random.default_rng(seed)
    protos = _prototypes(rng, n_classes, image_size)
    x, y = _sample(rng, protos, n_train + n_test, noise)
    if class_subset is not None:
        sel = np.isin(y, class_subset)
        x, y = x[sel], y[sel]
        n_train = int(len(x) * n_train / (n_train + n_test))
    return (x[:n_train], y[:n_train], x[n_train:], y[n_train:])


def mixed_cifar(n_clients=5, n_per_client=1000, n_test=200, seed=0,
                noise=0.25) -> List[ClientData]:
    """10 classes split into ``n_clients`` subsets of 2 classes each."""
    out = []
    per_class = 10 // n_clients
    for i in range(n_clients):
        classes = list(range(per_class * i, per_class * (i + 1)))
        # same generative seed for ALL clients: one shared dataset
        xtr, ytr, xte, yte = _make_dataset(
            seed, (n_per_client + n_test) * 6, 0, noise=noise,
            class_subset=None)
        sel = np.isin(ytr, classes)
        x, y = xtr[sel][: n_per_client + n_test], ytr[sel][: n_per_client + n_test]
        out.append(ClientData(x[:n_per_client], y[:n_per_client],
                              x[n_per_client:], y[n_per_client:],
                              dataset_id=0))
    return out


def mixed_noniid(n_clients=5, n_per_client=1000, n_test=200, seed=0
                 ) -> List[ClientData]:
    """Client i holds pseudo-dataset i (distinct prototypes AND noise)."""
    noises = [0.10, 0.25, 0.20, 0.35, 0.15]  # heterogeneous difficulty
    out = []
    for i in range(n_clients):
        xtr, ytr, xte, yte = _make_dataset(
            seed + 1000 * (i + 1), n_per_client, n_test,
            noise=noises[i % len(noises)])
        out.append(ClientData(xtr, ytr, xte, yte, dataset_id=i))
    return out


def batch_iterator(data: ClientData, batch_size: int, rng: np.random.Generator
                   ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """One epoch of shuffled minibatches (drops remainder)."""
    idx = rng.permutation(len(data.x))
    for s in range(0, len(idx) - batch_size + 1, batch_size):
        sel = idx[s: s + batch_size]
        yield data.x[sel], data.y[sel]
