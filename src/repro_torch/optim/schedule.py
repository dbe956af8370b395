"""Learning-rate schedules: callables step -> lr (0-dim float32 tensors on
the step's device), usable as Adam's ``lr``."""

from __future__ import annotations

import math

import torch


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32, device=step.device)


def cosine_decay(lr: float, decay_steps: int, alpha: float = 0.0):
    def f(step):
        t = torch.clamp(step.to(torch.float32), max=decay_steps) / decay_steps
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return lr * ((1 - alpha) * cos + alpha)

    return f


def warmup_cosine(lr: float, warmup_steps: int, decay_steps: int,
                  alpha: float = 0.1):
    cos = cosine_decay(lr, decay_steps, alpha)

    def f(step):
        s = step.to(torch.float32)
        warm = lr * s / max(warmup_steps, 1)
        return torch.where(s < warmup_steps, warm, cos(step - warmup_steps))

    return f
