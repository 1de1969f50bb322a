"""Learning-rate schedules: cosine and WSD (warmup-stable-decay, MiniCPM §4).

Copies of the JAX package's ``optim/schedule.py``. Each returns ``f(step)``
for an int or a 0-d tensor step and gives a 0-d float32 tensor, computed in
float32 with the reference's operations, so that the port's AdamW takes the
reference's learning rate.

WSD is minicpm-2b's recipe: linear warmup → long constant plateau → short
(typically 10%) decay, which lets pretraining continue from any plateau
checkpoint.
"""

from __future__ import annotations

import math
from typing import Any

import torch

__all__ = ["linear_warmup_cosine", "wsd", "constant"]


def _f32(step: Any) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def linear_warmup_cosine(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    def f(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak_lr + (1 - floor) * peak_lr * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return f


def wsd(peak_lr: float, warmup: int, total: int, decay_frac: float = 0.1,
        floor: float = 0.01):
    """Warmup-Stable-Decay: MiniCPM's schedule."""
    decay_start = int(total * (1 - decay_frac))

    def f(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup, 1)
        t = torch.clamp((step - decay_start) / max(total - decay_start, 1), 0.0, 1.0)
        # exponential-style decay to floor (the paper uses ~exp decay)
        dec = peak_lr * torch.pow(torch.tensor(floor, dtype=torch.float32, device=t.device), t)
        stable = torch.full_like(step, peak_lr)
        return torch.where(step < warmup, warm, torch.where(step < decay_start, stable, dec))
    return f


def constant(lr: float):
    def f(step):
        return torch.full_like(_f32(step), lr)
    return f
