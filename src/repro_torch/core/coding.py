"""Input spike coding (paper §3.2).

  - ``rate_encode``  : Bernoulli rate coding, intensity == per-step spike
    probability (the paper's choice; Fig. 2).  Draws from a
    ``torch.Generator``, so it does not reproduce the reference's bits.
    It is ``rate_code(x, rate_uniforms(generator, ...))``: the draw, then
    a draw-free comparison, which a CUDA graph can capture over uniforms
    drawn outside it (the serving engine's graphed admission).
  - ``rate_encode_deterministic`` : round(p*T) evenly spaced spikes.
  - ``ttfs_encode``  : time-to-first-spike, brighter pixels fire earlier.
  - ``delta_encode`` : delta modulation over an input sequence, spikes on
    signal change.

All return a (T, *x.shape) float32 tensor with time leading, in {0,1}
({-1,0,1} for delta).
"""

from __future__ import annotations

from typing import Optional

import torch


def rate_uniforms(
    generator: torch.Generator,
    shape,
    device=None,
    *,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The draw of ``rate_encode``: float32 uniforms in [0, 1) of
    ``shape`` from ``generator``, into ``out`` when given (its shape and
    device), with the same values as a fresh ``torch.rand``."""
    if out is None:
        return torch.rand(
            tuple(shape), generator=generator, dtype=torch.float32,
            device=device,
        )
    return out.uniform_(0.0, 1.0, generator=generator)


def rate_code(x: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
    """The draw-free half of ``rate_encode``: a spike wherever the
    uniform lies below the clamped intensity, (T, *x.shape) float32."""
    return (uniforms < torch.clamp(x, 0.0, 1.0)).to(torch.float32)


def rate_encode(
    generator: torch.Generator, x: torch.Tensor, num_steps: int
) -> torch.Tensor:
    """Bernoulli rate coding.  ``x`` must be normalized to [0, 1]; the
    generator must live on ``x``'s device."""
    u = rate_uniforms(generator, (num_steps,) + tuple(x.shape), x.device)
    return rate_code(x, u)


def rate_encode_deterministic(x: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Deterministic rate coding via phase accumulation: spike at step t
    iff floor(t*p) > floor((t-1)*p)."""
    p = torch.clamp(x, 0.0, 1.0)
    t = torch.arange(1, num_steps + 1, dtype=torch.float32, device=x.device)
    acc_t = torch.floor(t[:, None] * p.reshape(1, -1))
    acc_prev = torch.floor((t - 1)[:, None] * p.reshape(1, -1))
    spikes = (acc_t > acc_prev).to(torch.float32)
    return spikes.reshape((num_steps,) + tuple(x.shape))


def ttfs_encode(x: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Time-to-first-spike: intensity 1.0 fires at t=0, 0 never fires."""
    p = torch.clamp(x, 0.0, 1.0)
    t_fire = torch.where(
        p > 0,
        torch.round((1.0 - p) * (num_steps - 1)),
        torch.full_like(p, float(num_steps)),
    )
    t = torch.arange(num_steps, dtype=t_fire.dtype, device=x.device)
    shape = (num_steps,) + (1,) * x.dim()
    return (t.reshape(shape) == t_fire[None]).to(torch.float32)


def delta_encode(x_seq: torch.Tensor, threshold: float = 0.1) -> torch.Tensor:
    """Delta modulation over a (T, ...) input sequence.

    Emits +1 when the signal rises by at least ``threshold`` above the
    last emitted level, -1 when it falls as far; the level moves by
    ``threshold`` per spike, so encoding error does not drift.
    """
    level = torch.zeros_like(x_seq[0])
    spikes = []
    for x_t in x_seq:
        diff = x_t - level
        spike = (diff >= threshold).to(x_seq.dtype) - (diff <= -threshold).to(
            x_seq.dtype
        )
        level = level + spike * threshold
        spikes.append(spike)
    return torch.stack(spikes)


def spike_rate(spikes: torch.Tensor) -> torch.Tensor:
    """Mean firing rate over the time axis, used by the energy model."""
    return torch.mean(spikes, dim=0)
