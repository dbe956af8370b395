"""Address-Event Representation (AER) spike tensors.

- ``EventStream``: fixed-capacity event tensors ``(times, addrs, polarity,
  count)``; ``count`` marks how many leading events are valid.
- ``dense_to_aer`` / ``aer_to_dense``: lossless round trip whenever the
  capacity covers the active entries; on overflow the earliest events
  (time-major order) are kept.
- ``merge``: time-ordered merge of two streams over one address space.
- ``StepEventTable``: one fixed-capacity, valid-first event list per time
  step (the device-resident staging format), so slicing the step axis
  yields a chunk's worth of ready-to-gather events.  Addresses are int16
  when the address space fits, values int8 signed spike magnitudes.
- ``input_planes``: polarity-aware input spike planes of a DVS stream.
- ``dvs_collision_batch``: a synthetic DVS camera for the collision
  scenario.  Its random draws come from a ``torch.Generator`` and the
  renderer takes them as tensors (``DVSDraws``), so a caller can feed it
  any draws, the reference's included.

Padding convention of ``EventStream``: invalid slots have ``times ==
num_steps``, ``addrs == 0`` and ``polarity == 0``; valid events are sorted
by (time, address) ascending.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import coding


class EventStream(NamedTuple):
    """Fixed-capacity AER event tensor with optional leading batch dims.

    times:    (..., E) int32 time step of each event
    addrs:    (..., E) int32 flattened neuron / pixel address
    polarity: (..., E) int8 +1 / -1 event sign (0 on padding)
    count:    (...,)   int32 number of valid leading events (<= E)
    """

    times: torch.Tensor
    addrs: torch.Tensor
    polarity: torch.Tensor
    count: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.times.shape[-1]

    @property
    def batch_shape(self) -> Tuple[int, ...]:
        return tuple(self.times.shape[:-1])


def dense_to_aer(spikes: torch.Tensor, capacity: int) -> EventStream:
    """Convert a dense spike train (T, ..., N) into an AER stream.

    Events are ordered time-major (all step-0 events before step-1, in
    address order within a step).  If more than ``capacity`` entries are
    active, the earliest ``capacity`` events are kept.
    """
    T, N = spikes.shape[0], spikes.shape[-1]
    batch_shape = tuple(spikes.shape[1:-1])
    x = torch.movedim(spikes, 0, -2).reshape(batch_shape + (T * N,))
    active = x != 0
    # stable sort: active entries first, time-major order kept
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


def aer_to_dense(
    stream: EventStream, num_steps: int, num_addrs: int
) -> torch.Tensor:
    """Scatter an AER stream back to a dense (T, ..., N) float32 train.
    Events past ``count`` or outside the (T, N) plane are dropped."""
    E = stream.capacity
    batch_shape = stream.batch_shape
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


def merge(
    a: EventStream,
    b: EventStream,
    *,
    num_addrs: int,
    capacity: int,
    num_steps: Optional[int] = None,
) -> EventStream:
    """Time-ordered merge of two streams over one address space.

    Keeps the earliest ``capacity`` events of the union (AER bus arbiter
    semantics); ``capacity`` may exceed the combined input capacity, and
    the tail is then padded.  Both inputs follow the padding convention.
    Padding is stamped at ``num_steps`` (the T both streams were encoded
    with) or, without it, at one past the latest time in the inputs, which
    still sorts after every valid event but may lie inside a longer
    window (``runtime.event_forward_aer`` masks it by polarity).
    """
    times = torch.cat([a.times, b.times], dim=-1).to(torch.int64)
    addrs = torch.cat([a.addrs, b.addrs], dim=-1).to(torch.int64)
    pol = torch.cat([a.polarity, b.polarity], dim=-1)
    # padding (times == T_pad, addrs == 0) sorts after every valid event
    key = times * num_addrs + addrs
    take = min(capacity, times.shape[-1])
    order = torch.argsort(key, dim=-1, stable=True)[..., :take]
    count = torch.clamp(a.count + b.count, max=capacity).to(torch.int32)
    valid = torch.arange(capacity, device=times.device) < count[..., None]
    out_t, out_a, out_p = (
        torch.gather(x, -1, order) for x in (times, addrs, pol)
    )
    if capacity > take:
        pad = (0, capacity - take)
        out_t, out_a, out_p = (
            torch.nn.functional.pad(x, pad) for x in (out_t, out_a, out_p)
        )
    if num_steps is not None:
        pad_t = torch.full_like(times[..., :1], num_steps)
    else:
        pad_t = times.max(dim=-1, keepdim=True).values + 1
    return EventStream(
        times=torch.where(valid, out_t, pad_t).to(torch.int32),
        addrs=torch.where(valid, out_a, 0).to(torch.int32),
        polarity=torch.where(valid, out_p, 0).to(torch.int8),
        count=count,
    )


class StepEventTable(NamedTuple):
    """Packed per-step AER event lists of a dense spike train.

    addrs:  (..., T, C) int16/int32 event addresses, packed valid-first
    values: (..., T, C) int8 signed spike magnitudes (0 on padding)
    counts: (..., T) int32 valid events per step
    """

    addrs: torch.Tensor
    values: torch.Tensor
    counts: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.addrs.shape[-1]

    @property
    def num_steps(self) -> int:
        return self.addrs.shape[-2]


def addr_dtype_for(num_addrs: int) -> torch.dtype:
    """Narrowest integer dtype that can index ``num_addrs`` addresses."""
    return (
        torch.int16
        if num_addrs <= torch.iinfo(torch.int16).max
        else torch.int32
    )


def check_addr_dtype(num_addrs: int, addr_dtype: torch.dtype) -> None:
    """Raise if ``addr_dtype`` cannot index ``num_addrs`` addresses: a
    narrowing cast of an out-of-range address wraps silently."""
    info = torch.iinfo(addr_dtype)
    if num_addrs - 1 > int(info.max):
        raise ValueError(
            f"address dtype {addr_dtype} cannot index {num_addrs} "
            f"addresses (max {int(info.max) + 1}): int16 AER tables "
            "silently wrap — use addr_dtype_for(num_addrs) or int32"
        )


def step_table_to_dense(table: StepEventTable, num_addrs: int) -> torch.Tensor:
    """Scatter a per-step event table back to a dense (..., T, N) train.

    Inverse of ``runtime.encode_step_table`` whenever the capacity covered
    each step's events at encode time.
    """
    C = table.capacity
    valid = (
        torch.arange(C, device=table.counts.device) < table.counts[..., None]
    )
    idx = torch.where(
        valid, table.addrs.long(), torch.full_like(table.addrs.long(), num_addrs)
    )
    vals = torch.where(valid, table.values.to(torch.float32), 0.0)
    lead = tuple(table.addrs.shape[:-1])
    flat_idx = idx.reshape(-1, C)
    dense = torch.zeros(
        (flat_idx.shape[0], num_addrs + 1),
        dtype=torch.float32,
        device=flat_idx.device,
    )
    dense.scatter_add_(1, flat_idx, vals.reshape(-1, C))
    return dense[:, :num_addrs].reshape(lead + (num_addrs,))


# --------------------------------------------------------------------------
# Polarity-aware input planes (ON/OFF channels of a DVS stream)
# --------------------------------------------------------------------------

POLARITY_MODES = ("two_channel", "signed", "on_only")


def _check_polarity_mode(polarity_mode: str) -> None:
    if polarity_mode not in POLARITY_MODES:
        raise ValueError(
            f"unknown polarity mode {polarity_mode!r}; have {POLARITY_MODES}"
        )


def input_size_for(num_addrs: int, polarity_mode: str) -> int:
    """Input-layer fan-in required for a stream over ``num_addrs`` pixels."""
    _check_polarity_mode(polarity_mode)
    return 2 * num_addrs if polarity_mode == "two_channel" else num_addrs


def input_planes(
    stream: EventStream,
    num_steps: int,
    num_addrs: int,
    *,
    polarity_mode: str = "two_channel",
) -> torch.Tensor:
    """Densify an AER stream into SNN input spike planes, polarity-aware.

    - ``"two_channel"``: (T, ..., 2*num_addrs); ON events spike channel
      block [0, K), OFF events [K, 2K), each with its own weight rows.
    - ``"signed"``: (T, ..., num_addrs) in {-1, 0, +1}; polarity rides on
      the event value through the shared weight row (coincident ON+OFF at
      one pixel and step cancel, as on a shared wire).
    - ``"on_only"``: (T, ..., num_addrs) in {0,1}, ON events only.

    Channel modes densify each polarity separately and clip duplicate
    events to unit magnitude, so the planes stay valid spike trains.
    """
    _check_polarity_mode(polarity_mode)
    if polarity_mode == "signed":
        return torch.clamp(aer_to_dense(stream, num_steps, num_addrs), -1.0, 1.0)
    on = torch.clamp(
        aer_to_dense(
            stream._replace(polarity=torch.clamp(stream.polarity, min=0)),
            num_steps, num_addrs,
        ),
        0.0, 1.0,
    )
    if polarity_mode == "on_only":
        return on
    off = torch.clamp(
        -aer_to_dense(
            stream._replace(polarity=torch.clamp(stream.polarity, max=0)),
            num_steps, num_addrs,
        ),
        0.0, 1.0,
    )
    return torch.cat([on, off], dim=-1)


# --------------------------------------------------------------------------
# Synthetic DVS event camera for the collision-avoidance scenario
# --------------------------------------------------------------------------


class DVSDraws(NamedTuple):
    """The random draws of a batch of synthetic recordings, each (B,).

    label: int64, 1 = collision (centred obstacle growing as it nears),
           0 = an obstacle passing across the periphery
    cy:    float32 obstacle row, in pixels
    cx_c:  float32 column of the collision obstacle, in pixels
    x0:    float32 start column of the passing obstacle, in pixels
    """

    label: torch.Tensor
    cy: torch.Tensor
    cx_c: torch.Tensor
    x0: torch.Tensor


def dvs_draws(
    generator: torch.Generator, batch: int, image_hw: int
) -> DVSDraws:
    """Draw ``batch`` recordings' parameters on the generator's device,
    with the reference's distributions."""
    u = torch.rand((4, batch), generator=generator, device=generator.device)
    hw = float(image_hw)
    return DVSDraws(
        label=(u[0] < 0.5).long(),
        cy=hw * (0.5 + 0.2 * u[1]),
        cx_c=hw * (0.5 + 0.2 * (u[2] - 0.5)),
        x0=hw * (0.05 + 0.2 * u[3]),
    )


def _render_frames(draws: DVSDraws, image_hw: int, num_steps: int) -> torch.Tensor:
    """(B, T, hw, hw) grayscale frames over a graded ground plane: an
    obstacle approaching (label 1) or passing laterally (label 0)."""
    hw, T = image_hw, num_steps
    dev = draws.cy.device
    grid = torch.arange(hw, device=dev)
    yy, xx = grid[:, None], grid[None, :]
    t = torch.arange(T, dtype=torch.float32, device=dev)[:, None, None]
    bg = 0.35 + 0.4 * (yy / hw)

    def per_rec(x):  # (B,) -> (B, 1, 1, 1)
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


def dvs_collision_stream(
    draws: DVSDraws,
    *,
    image_hw: int = 64,
    num_steps: int = 25,
    capacity: int = 2048,
    delta_threshold: float = 0.1,
) -> Tuple[EventStream, torch.Tensor]:
    """Render recordings from their draws and encode their brightness
    changes: (stream with (B,) batch dim over ``image_hw**2`` pixel
    addresses, (B,) labels).

    Frame 0 is emitted against black (every DVS dump starts with the
    reference frame's delta), then only changes spike, so the event count
    measures scene motion.
    """
    frames = _render_frames(draws, image_hw, num_steps)  # (B, T, hw, hw)
    B = frames.shape[0]
    flat = frames.reshape(B, num_steps, image_hw * image_hw).transpose(0, 1)
    spikes = coding.delta_encode(flat, threshold=delta_threshold)  # (T, B, P)
    return dense_to_aer(spikes, capacity), draws.label


def dvs_collision_batch(
    generator: torch.Generator,
    batch: int,
    *,
    image_hw: int = 64,
    num_steps: int = 25,
    capacity: int = 2048,
    delta_threshold: float = 0.1,
) -> Tuple[EventStream, torch.Tensor]:
    """A batch of synthetic DVS recordings drawn from ``generator``, on
    its device: (stream with (B,) batch dim, (B,) labels)."""
    return dvs_collision_stream(
        dvs_draws(generator, batch, image_hw),
        image_hw=image_hw,
        num_steps=num_steps,
        capacity=capacity,
        delta_threshold=delta_threshold,
    )
