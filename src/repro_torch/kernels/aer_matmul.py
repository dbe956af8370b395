"""Event-driven synaptic integration: one launch per event table.

``aer_spike_matmul_batched`` computes

    out[b, n] = sum_e values[b, e] * weights[addrs[b, e], n]

for B streams of E events each, and ``aer_spike_matmul`` the same for one
stream, ``out[n]``, in int32 (the reference's single-stream kernel, run
here on the batched kernel with B = 1, where ``plan`` splits E across
CTAs).  On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/aer_matmul.cu`` (built at first use) or raises, and a CUDA graph
may capture it (``captured`` counts such launches beside ``launches``;
the launcher raises the shared-memory limit once, at the first eager
launch that needs it, never during a capture); on a CPU tensor it
runs ``aer_spike_matmul_batched_ref``, the plain PyTorch version, which
adds one event at a time in the kernel's order, so on the card the two
agree value for value.

Contracts, those of the reference's ``repro.kernels.aer_matmul``:

- int16 weights with integer values (int8/int16/int32) accumulate in
  int32, bit-exact against ``aer_spike_matmul_ref`` per stream;
- float32 weights with float32 values accumulate in float32 (the
  surrogate-gradient training forward).

An event whose value is 0 (padding) or whose address lies outside
[0, K) contributes nothing, and no row outside [0, K) is ever read.

The contract holds on valid input: an address in [0, K) on every live
event, and finite float32 weights.  Padding slots point at row 0
(``runtime.step_events``); the reference's Pallas kernel multiplies the
padding slots of every E block that holds a live event (0 * inf is NaN)
and skips a block that holds none, so for a non-finite row that padding
addresses its answer depends on its TPU tiling (``block_e``).  The port
adds live events only, so a non-finite row reaches a sum only where a
live event reads it.

``plan`` is the kernel's launch geometry: which of its four variants runs
(for float32 ``merged`` at N >= 32, ``narrow`` at N < 32, ``rows`` where
the merged CTA's shared memory does not fit; ``split`` for int16 weights,
E split across CTAs), the streams, columns and events a CTA takes, and
its shared memory.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

Tensor = torch.Tensor
_INT_VALUES = (torch.int8, torch.int16, torch.int32)
# the launcher's variant codes (csrc/aer_matmul.cu: AER_ROWS, ...)
VARIANTS = {"rows": 0, "narrow": 1, "split": 2, "merged": 3}
SMS = 132  # SMs of an H100
SPLIT_CTAS = 4 * SMS  # the int16 split aims at about four CTAs an SM
GRID_YZ_MAX = 65535
INT_MAX = 2**31 - 1
# dynamic shared memory a CTA may take: 227 KB less 1 KB for the static
# (csrc/aer_matmul.cu: AER_SMEM_MAX)
SMEM_LIMIT = 231424
TILE_ROWS = 256  # W rows a tile of the merged walk (AER_TILE_ROWS)
MERGE_MAX = 4  # streams a merged CTA (AER_MERGE_MAX)
GROUP = 128  # threads a ring, and a stream of a merged CTA (AER_GROUP)
LEAD = 2  # E-blocks of rows in flight in a ring (AER_LEAD)
NARROW_N = 32  # float32 layers narrower than this take the narrow variant


@dataclass(frozen=True)
class Plan:
    """Launch geometry of one ``aer_spike_matmul_batched`` call: a grid of
    (ceil(B / streams), slices, splits) CTAs of ``threads`` threads
    (``GROUP`` a stream), each adding ``cols`` columns of ``streams``
    streams over ``e_chunk`` events."""

    variant: str
    cols: int
    threads: int
    streams: int
    e_chunk: int
    slices: int
    splits: int
    ctas: int
    smem: int


def ring_bytes(threads: int, cols: int, wsize: int) -> int:
    """Shared memory of a ring of ``threads`` events a block: LEAD + 1
    slots of staged rows (each padded to 16 bytes) and 2 * LEAD + 1 slots
    of events (int32 address, 4-byte value); csrc: ring_bytes."""
    pitch = -(-cols * wsize // 16) * 16
    return (LEAD + 1) * threads * pitch + (2 * LEAD + 1) * threads * 8


def walk_bytes(streams: int, K: int, cols: int) -> int:
    """The merged walk's (streams, K) plane and two W tiles (float32)."""
    kp = -(-K // TILE_ROWS) * TILE_ROWS
    return streams * kp * 4 + 2 * TILE_ROWS * -(-cols * 4 // 16) * 16


@functools.lru_cache(maxsize=256)  # the trainer calls it 50 times a step
def plan(B: int, E: int, K: int, N: int, int16: bool) -> Plan:
    """The kernel's variant and geometry for B streams of E events into a
    (K, N) weight; raises where the grid cannot hold the shape.  A CTA
    takes 32 columns (all N below 32) and ``GROUP`` threads a stream.

    float32 keeps each (b, n) sum in one thread, e ascending:

    - ``merged`` at N >= ``NARROW_N`` when up to ``MERGE_MAX`` streams'
      (K,) planes fit: the CTA walks W once for its streams on dense,
      ascending input, else runs one ring a stream;
    - ``narrow`` below ``NARROW_N`` columns: the CTA ring over all N;
    - ``rows``, the CTA ring, when not even one plane fits.

    int16 sums wrap, so ``split`` (the CTA ring) cuts E into chunks until
    the grid holds about ``SPLIT_CTAS`` CTAs, never an empty chunk."""
    if min(B, E, N) < 0 or K < 1 or max(B, E, K, N) > INT_MAX:
        raise ValueError(
            f"aer_spike_matmul_batched: B={B}, E={E}, K={K}, N={N} out of range"
        )
    wsize = 2 if int16 else 4
    cols, streams, splits = min(32, max(N, 1)), 1, 1
    if int16:
        variant = "split"
    elif N < NARROW_N:
        variant = "narrow"
    else:
        fits = [s for s in range(min(MERGE_MAX, B), 0, -1)
                if walk_bytes(s, K, cols) <= SMEM_LIMIT]
        variant = "merged" if fits else "rows"
        streams = fits[0] if fits else 1
    threads = GROUP * streams
    slices = -(-N // cols)
    if slices > GRID_YZ_MAX:
        raise ValueError(f"aer_spike_matmul_batched: N={N} exceeds the grid")
    blocks = -(-E // threads)
    if int16 and blocks:
        splits = max(1, min(blocks, -(-SPLIT_CTAS // max(1, B * slices))))
        splits = -(-blocks // -(-blocks // splits))  # no empty chunk
    if variant == "merged":  # each CTA reads all E events of its streams
        e_chunk = E
        smem = max(walk_bytes(streams, K, cols),
                   streams * ring_bytes(GROUP, cols, wsize))
    else:
        e_chunk = -(-blocks // splits) * threads
        smem = ring_bytes(threads, cols, wsize)
    ctas = -(-B // streams) * slices * splits
    return Plan(variant, cols, threads, streams, e_chunk, slices, splits, ctas,
                smem)


def _check(addrs: Tensor, values: Tensor, weights: Tensor) -> None:
    if addrs.dim() != 2:
        raise ValueError(f"addrs must be (B, E), got {tuple(addrs.shape)}")
    if values.shape != addrs.shape:
        raise ValueError(
            f"values {tuple(values.shape)} != addrs {tuple(addrs.shape)}"
        )
    if weights.dim() != 2 or weights.shape[0] < 1:
        raise ValueError(f"weights must be (K >= 1, N), got {tuple(weights.shape)}")
    if addrs.dtype != torch.int32:
        raise TypeError(f"addrs must be int32, got {addrs.dtype}")
    if weights.dtype == torch.int16:
        if values.dtype not in _INT_VALUES:
            raise TypeError(
                f"int16 weights take int8/int16/int32 values, got {values.dtype}"
            )
    elif weights.dtype == torch.float32:
        if values.dtype != torch.float32:
            raise TypeError(f"float32 weights take float32 values, got {values.dtype}")
    else:
        raise TypeError(f"weights must be int16 or float32, got {weights.dtype}")


def aer_spike_matmul_batched(
    addrs: Tensor,  # (B, E) int32 event addresses
    values: Tensor,  # (B, E) signed event values, 0 on padding
    weights: Tensor,  # (K, N) int16 Q1.15 codes or float32 weights
) -> Tensor:
    """(B, N) int32 for int16 weights, float32 for float32 weights;
    the weights must be finite (module docstring)."""
    if not addrs.is_cuda:
        return aer_spike_matmul_batched_ref(addrs, values, weights)
    out = _launch(addrs, values, weights)
    _count(aer_spike_matmul_batched)
    return out


aer_spike_matmul_batched.launches = 0  # kernel launches since the last reset
# launches recorded into CUDA graphs being captured since the last reset; a
# graph launches each of them once per replay (the trainer counts replays)
aer_spike_matmul_batched.captured = 0


def _count(wrapper) -> None:
    """One more launch of ``wrapper``'s kernel: ``captured`` when a CUDA
    graph records it (it then runs at each replay), else ``launches``."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


def _launch(addrs: Tensor, values: Tensor, weights: Tensor) -> Tensor:
    """Launch ``csrc/aer_matmul.cu`` on (B, E) tables; counts nothing."""
    _check(addrs, values, weights)
    dev = addrs.device
    if values.device != dev or weights.device != dev:
        raise ValueError(
            "aer_spike_matmul_batched: every tensor must be on the device of addrs"
        )
    B, E = addrs.shape
    K, N = weights.shape
    int16 = weights.dtype == torch.int16
    geo = plan(B, E, K, N, int16)
    acc = torch.int32 if int16 else torch.float32
    addrs = addrs.contiguous()
    values = values.to(acc).contiguous()
    weights = weights.contiguous()
    # split partials meet by atomicAdd: they need a zeroed output
    alloc = torch.zeros if geo.splits > 1 else torch.empty
    out = alloc((B, N), dtype=acc, device=dev)

    from repro_torch.kernels import _build

    launch = _build.load("aer_matmul")
    rc = launch(
        addrs.data_ptr(), values.data_ptr(), weights.data_ptr(),
        out.data_ptr(), B, E, K, N, int(int16), VARIANTS[geo.variant],
        geo.cols, geo.threads, geo.streams, geo.e_chunk, geo.slices,
        geo.splits, geo.smem, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"aer_matmul kernel launch failed: CUDA error {rc}")
    return out


def aer_spike_matmul_batched_ref(
    addrs: Tensor, values: Tensor, weights: Tensor
) -> Tensor:
    """Plain PyTorch version of ``aer_spike_matmul_batched`` on any device.

    Repeats the kernel's arithmetic: for e ascending, every stream adds
    ``values[b, e] * weights[addrs[b, e]]`` where the event is live
    (nonzero value, address in [0, K)), each product and sum rounded
    separately (int32 wraps).  Reads the number of events to walk back to
    the host, so it synchronises with the device.
    """
    _check(addrs, values, weights)
    K, N = weights.shape
    if weights.dtype == torch.int16:
        w, v = weights.to(torch.int32), values.to(torch.int32)
    else:
        w, v = weights, values
    a = addrs.long()
    live = (v != 0) & (a >= 0) & (a < K)
    a = torch.where(live, a, 0)
    acc = torch.zeros((addrs.shape[0], N), dtype=w.dtype, device=w.device)
    idx = torch.arange(1, addrs.shape[1] + 1, device=addrs.device)
    n_walk = int((live * idx).max()) if live.numel() else 0
    for e in range(n_walk):
        term = v[:, e : e + 1] * w[a[:, e]]
        acc = torch.where(live[:, e : e + 1], acc + term, acc)
    return acc


def _check_single(addrs: Tensor, values: Tensor, weights_q: Tensor) -> None:
    if addrs.dim() != 1 or values.shape != addrs.shape:
        raise ValueError(
            f"addrs and values must be (E,), got {tuple(addrs.shape)} and "
            f"{tuple(values.shape)}"
        )
    if weights_q.dim() != 2 or weights_q.shape[0] < 1:
        raise ValueError(f"weights_q must be (K >= 1, N), got {tuple(weights_q.shape)}")
    if addrs.dtype != torch.int32:
        raise TypeError(f"addrs must be int32, got {addrs.dtype}")
    if values.dtype not in _INT_VALUES + (torch.int64,):
        raise TypeError(f"values must be an integer type, got {values.dtype}")
    if weights_q.dtype != torch.int16:
        raise TypeError(f"weights_q must be int16, got {weights_q.dtype}")


def aer_spike_matmul(
    addrs: Tensor,  # (E,) int32 event addresses in [0, K)
    values: Tensor,  # (E,) integer event values, 0 on padding
    weights_q: Tensor,  # (K, N) int16 Q1.15 codes
) -> Tensor:
    """(N,) int32: ``sum_e values[e] * weights_q[addrs[e], n]``, the
    values cast to int32 first as the reference does.  Dequantize with
    /2^15."""
    if not addrs.is_cuda:
        return aer_spike_matmul_ref(addrs, values, weights_q)
    _check_single(addrs, values, weights_q)
    out = _launch(addrs[None], values.to(torch.int32)[None], weights_q)
    _count(aer_spike_matmul)
    return out[0]


aer_spike_matmul.launches = 0  # kernel launches since the last reset
aer_spike_matmul.captured = 0  # launches recorded into CUDA graphs


def aer_spike_matmul_ref(
    addrs: Tensor, values: Tensor, weights_q: Tensor
) -> Tensor:
    """Plain PyTorch version of ``aer_spike_matmul`` on any device: the
    live events' rows gathered, weighted and summed in int64, wrapped to
    int32 (integer sums agree in any order).  A live event has a nonzero
    value and an address in [0, K), as in the kernel; the reference
    leaves an out-of-range address on a live event undefined."""
    _check_single(addrs, values, weights_q)
    K = weights_q.shape[0]
    v = values.to(torch.int32)
    a = addrs.long()
    live = (v != 0) & (a >= 0) & (a < K)
    rows = weights_q[torch.where(live, a, 0)].to(torch.int64)
    v = torch.where(live, v, 0).to(torch.int64)
    return (rows * v[:, None]).sum(0).to(torch.int32)
