"""Surrogate-gradient spike functions.

Forward is always the exact Heaviside step (1 where ``u >= 0``); only the
backward pass is a smooth surrogate:

  - ``atan``        : d/du = alpha / (2*(1+(pi/2*alpha*u)^2))
  - ``fast_sigmoid``: d/du = 1 / (slope*|u| + 1)^2
  - ``boxcar``      : d/du = 1[|u| < width/2]
"""

from __future__ import annotations

import functools
import math
from typing import Callable

import torch


def _heaviside(u: torch.Tensor) -> torch.Tensor:
    """Exact spike forward: 1.0 where u >= 0 (u is membrane - threshold)."""
    return (u >= 0.0).to(u.dtype)


def _make_spike_fn(
    grad_fn: Callable[[torch.Tensor], torch.Tensor],
) -> Callable[[torch.Tensor], torch.Tensor]:
    class _Spike(torch.autograd.Function):
        @staticmethod
        def forward(ctx, u):
            ctx.save_for_backward(u)
            return _heaviside(u)

        @staticmethod
        def backward(ctx, g):
            (u,) = ctx.saved_tensors
            return g * grad_fn(u)

    return _Spike.apply


def atan(alpha: float = 2.0) -> Callable[[torch.Tensor], torch.Tensor]:
    """ATan surrogate (snntorch default)."""

    def grad_fn(u):
        return alpha / (2.0 * (1.0 + (math.pi / 2.0 * alpha * u) ** 2))

    return _make_spike_fn(grad_fn)


def fast_sigmoid(slope: float = 25.0) -> Callable[[torch.Tensor], torch.Tensor]:
    """Fast-sigmoid surrogate (SuperSpike)."""

    def grad_fn(u):
        return 1.0 / (slope * torch.abs(u) + 1.0) ** 2

    return _make_spike_fn(grad_fn)


def boxcar(width: float = 1.0) -> Callable[[torch.Tensor], torch.Tensor]:
    """Straight-through / boxcar surrogate."""

    def grad_fn(u):
        return (torch.abs(u) < width / 2.0).to(u.dtype)

    return _make_spike_fn(grad_fn)


_REGISTRY = {
    "atan": atan,
    "fast_sigmoid": fast_sigmoid,
    "boxcar": boxcar,
}


@functools.lru_cache(maxsize=None)
def get(name: str, **kwargs) -> Callable[[torch.Tensor], torch.Tensor]:
    """Look up a surrogate spike fn by name (kwargs must be hashable)."""
    if name not in _REGISTRY:
        raise ValueError(f"unknown surrogate {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)
