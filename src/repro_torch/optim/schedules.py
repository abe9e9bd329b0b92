"""LR schedules (port of ``repro.optim.schedules``): each maps a step
(an int or a tensor) to a float32 learning rate."""
from __future__ import annotations

import math

import torch


def _f32(step):
    return torch.as_tensor(step, dtype=torch.float32)


def constant(lr):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_decay(lr, total_steps, final_frac=0.1):
    def f(step):
        t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        return lr * (final_frac + (1 - final_frac)
                     * 0.5 * (1 + torch.cos(math.pi * t)))
    return f


def linear_warmup_cosine(lr, warmup, total_steps, final_frac=0.1):
    cos = cosine_decay(lr, max(total_steps - warmup, 1), final_frac)

    def f(step):
        step = _f32(step)
        w = torch.clamp(step / max(warmup, 1), 0.0, 1.0)
        return torch.where(step < warmup, lr * w, cos(step - warmup))
    return f
