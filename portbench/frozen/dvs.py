"""A frozen copy of the port's synthetic DVS event camera
(``repro_torch/events/aer.py``: ``dvs_draws``, ``_render_frames``,
``dvs_collision_batch``, ``dense_to_aer``, ``aer_to_dense``,
``input_planes``; ``core/coding.py``: ``delta_encode``), with the same
arithmetic, so the cells' recordings stay what they are whatever the
program does to its own copy."""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


class EventStream(NamedTuple):
    times: torch.Tensor
    addrs: torch.Tensor
    polarity: torch.Tensor
    count: torch.Tensor


class DVSDraws(NamedTuple):
    label: torch.Tensor
    cy: torch.Tensor
    cx_c: torch.Tensor
    x0: torch.Tensor


def dvs_draws(generator: torch.Generator, batch: int, image_hw: int) -> DVSDraws:
    u = torch.rand((4, batch), generator=generator, device=generator.device)
    hw = float(image_hw)
    return DVSDraws(
        label=(u[0] < 0.5).long(),
        cy=hw * (0.5 + 0.2 * u[1]),
        cx_c=hw * (0.5 + 0.2 * (u[2] - 0.5)),
        x0=hw * (0.05 + 0.2 * u[3]),
    )


def render_frames(draws: DVSDraws, image_hw: int, num_steps: int) -> torch.Tensor:
    """(B, T, hw, hw) grayscale frames over a graded ground plane: an
    obstacle approaching (label 1) or passing laterally (label 0)."""
    hw, T = image_hw, num_steps
    dev = draws.cy.device
    grid = torch.arange(hw, device=dev)
    yy, xx = grid[:, None], grid[None, :]
    t = torch.arange(T, dtype=torch.float32, device=dev)[:, None, None]
    bg = 0.35 + 0.4 * (yy / hw)

    def per_rec(x):
        return x.to(torch.float32)[:, None, None, None]

    size_c = hw * (0.06 + 0.30 * t / T)
    cx_n = per_rec(draws.x0) + (hw * 0.6) * t / T
    size_n = torch.full_like(t, hw * 0.05)
    collide = per_rec(draws.label) == 1
    cx = torch.where(collide, per_rec(draws.cx_c), cx_n)
    size = torch.where(collide, size_c, size_n)
    obstacle = (torch.abs(xx - cx) < size) & (
        torch.abs(yy - per_rec(draws.cy)) < size * 1.2
    )
    return torch.where(obstacle, 0.08, bg).to(torch.float32)


def delta_encode(x_seq: torch.Tensor, threshold: float = 0.1) -> torch.Tensor:
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


def dense_to_aer(spikes: torch.Tensor, capacity: int) -> EventStream:
    T, N = spikes.shape[0], spikes.shape[-1]
    batch_shape = tuple(spikes.shape[1:-1])
    x = torch.movedim(spikes, 0, -2).reshape(batch_shape + (T * N,))
    active = x != 0
    order = torch.argsort((~active).to(torch.uint8), dim=-1, stable=True)
    take = min(capacity, T * N)
    flat_idx = order[..., :take]
    count = torch.clamp(active.sum(dim=-1), max=capacity).to(torch.int32)
    valid = torch.arange(take, device=x.device) < count[..., None]
    times = torch.where(valid, flat_idx // N, T).to(torch.int32)
    addrs = torch.where(valid, flat_idx % N, 0).to(torch.int32)
    pol = torch.gather(x, -1, flat_idx)
    polarity = torch.where(valid, torch.sign(pol), 0).to(torch.int8)
    if capacity > take:
        pad = (0, capacity - take)
        times = torch.nn.functional.pad(times, pad, value=T)
        addrs = torch.nn.functional.pad(addrs, pad)
        polarity = torch.nn.functional.pad(polarity, pad)
    return EventStream(times=times, addrs=addrs, polarity=polarity, count=count)


def aer_to_dense(stream: EventStream, num_steps: int, num_addrs: int) -> torch.Tensor:
    E = stream.times.shape[-1]
    batch_shape = tuple(stream.times.shape[:-1])
    nb = math.prod(batch_shape)
    size = num_steps * num_addrs
    times = stream.times.reshape(nb, E).long()
    addrs = stream.addrs.reshape(nb, E).long()
    count = stream.count.reshape(nb, 1)
    valid = torch.arange(E, device=times.device) < count
    idx = times * num_addrs + addrs
    idx = torch.where(valid & (idx >= 0) & (idx < size), idx, size)
    flat = torch.zeros((nb, size + 1), dtype=torch.float32, device=idx.device)
    flat.scatter_add_(1, idx, stream.polarity.reshape(nb, E).to(torch.float32))
    dense = flat[:, :size].reshape(batch_shape + (num_steps, num_addrs))
    return torch.movedim(dense, -2, 0)


def input_planes(stream: EventStream, num_steps: int, num_addrs: int,
                 *, polarity_mode: str) -> torch.Tensor:
    """Polarity-aware (T, ..., K) input planes of a stream."""
    if polarity_mode == "signed":
        return torch.clamp(aer_to_dense(stream, num_steps, num_addrs), -1.0, 1.0)
    on = torch.clamp(aer_to_dense(
        stream._replace(polarity=torch.clamp(stream.polarity, min=0)),
        num_steps, num_addrs), 0.0, 1.0)
    if polarity_mode == "on_only":
        return on
    if polarity_mode != "two_channel":
        raise ValueError(f"unknown polarity mode {polarity_mode!r}")
    off = torch.clamp(-aer_to_dense(
        stream._replace(polarity=torch.clamp(stream.polarity, max=0)),
        num_steps, num_addrs), 0.0, 1.0)
    return torch.cat([on, off], dim=-1)


def dvs_collision_batch(generator: torch.Generator, batch: int, *,
                        image_hw: int, num_steps: int, capacity: int,
                        delta_threshold: float = 0.1
                        ) -> Tuple[EventStream, torch.Tensor]:
    """``batch`` recordings drawn from ``generator``, on its device: (the
    AER stream of their brightness changes, (B,) labels)."""
    draws = dvs_draws(generator, batch, image_hw)
    frames = render_frames(draws, image_hw, num_steps)
    B = frames.shape[0]
    flat = frames.reshape(B, num_steps, image_hw * image_hw).transpose(0, 1)
    spikes = delta_encode(flat, threshold=delta_threshold)
    return dense_to_aer(spikes, capacity), draws.label


def mix_seed(seed: int, step: int) -> int:
    """A generator seed that depends only on (seed, step): the port's
    ``sparse_train.trainer._mix``."""
    import numpy as np

    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(2)
    return int(state[0]) << 31 | int(state[1]) >> 1
