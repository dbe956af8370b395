"""Fused event-driven SNN chunk: one kernel launch per Tc-step chunk.

``snn_chunk`` advances an L-layer LIF/Lapicque network ``Tc`` steps for B
slots.  On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/snn_chunk.cu`` (built at first use; one thread-block cluster per
slot, laid out by ``plan``) or raises; on a CPU tensor it runs
``snn_chunk_ref``, the plain PyTorch version.  The wrapper reads nothing
back from the card and makes no call but the launch once a shape has run,
so a CUDA graph can capture it (``snn_chunk.captured`` counts such
launches, ``snn_chunk.launches`` the eager ones).  The plain version sums
in the kernel's order, sequentially over events for layer 0 and over k
for hidden layers, so on the card the two agree value for value.

Semantics are those of the reference's ``repro.kernels.snn_chunk``: event
lists packed valid-first with zero values on padding, frozen slots
(``active == 0``) hold their state and emit no spikes or events, layer-0
events are the staged counts and hidden-layer events the previous layer's
spike count.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence, Tuple

import torch

Tensor = torch.Tensor
ChunkResult = Tuple[Tensor, Tensor, Tensor, Tuple[Tensor, ...], Tuple[Tensor, ...]]

MAX_LAYERS = 128
SMEM_LIMIT = 232448  # dynamic shared memory a block may ask for on sm_90
CLUSTER = 8  # CTAs per slot; csrc/snn_chunk.cu: SNN_CLUSTER
MAX_THREADS = 512  # csrc/snn_chunk.cu: SNN_MAX_THREADS
STEP_BLOCK = 16  # most steps a block of the chunk runs at once
EVENT_BLOCK = 512  # csrc/snn_chunk.cu: SNN_EB


@dataclass(frozen=True)
class Plan:
    """Launch geometry of one ``snn_chunk`` call (csrc/snn_chunk.cu)."""

    cols: Tuple[int, ...]  # columns of each layer a CTA owns
    step_block: int  # steps run per block of the chunk
    threads: int
    smem: int  # dynamic shared-memory bytes per CTA
    ctas: int


def smem_bytes(widths: Sequence[int], step_block: int) -> int:
    """Shared memory of one CTA: owned state, currents, two parities of
    spike planes and counts, the gathered hidden input, staged events."""
    L = len(widths) - 1
    cols = [-(-n // CLUSTER) for n in widths[1:]]
    planes = step_block * sum(cols[:-1])
    kh = max(widths[1:L], default=0)
    words = (2 * sum(cols) + step_block * max(cols) + 2 * planes
             + 2 * (L - 1) * step_block + step_block * kh + 2 * step_block
             + 2 * step_block * EVENT_BLOCK)
    return 4 * words


def plan(widths: Sequence[int], steps: int, batch: int) -> Plan:
    """Columns per CTA, step block, threads and shared memory for a
    network of ``widths`` (K0, N_0, ..., N_{L-1}) over ``steps`` steps.
    The cluster is ``CLUSTER`` CTAs a slot: on the H100 a cluster of 16
    gave no steady gain at the serving chunk and ran 18-20 % slower at
    the evaluate chunk (PERF.md, Findings).
    The step block is as long as the thread and shared-memory limits let
    it be, balanced over the chunk; raises when one step does not fit."""
    widths = [int(w) for w in widths]
    if not 1 <= len(widths) - 1 <= MAX_LAYERS:
        raise ValueError(f"snn_chunk supports 1..{MAX_LAYERS} layers")
    if widths[0] * widths[1] >= 2**31:
        raise ValueError(
            f"snn_chunk stages layer-0 row offsets as int32: a "
            f"{widths[0]} x {widths[1]} weight is too large"
        )
    cols = tuple(-(-n // CLUSTER) for n in widths[1:])
    longest = max(1, min(STEP_BLOCK, steps, MAX_THREADS // max(1, cols[0])))
    while longest > 1 and smem_bytes(widths, longest) > SMEM_LIMIT:
        longest -= 1
    smem = smem_bytes(widths, longest)
    if smem > SMEM_LIMIT:
        raise ValueError(
            f"snn_chunk keeps each CTA's columns in shared memory: widths "
            f"{widths} over a cluster of {CLUSTER} need {smem} B for one "
            f"step, over the {SMEM_LIMIT} B a block can ask for"
        )
    blocks = -(-max(steps, 1) // longest)
    step_block = -(-max(steps, 1) // blocks)
    chains = max(step_block * cols[0], max(cols))
    threads = min(MAX_THREADS, max(32, -(-chains // 32) * 32))
    return Plan(cols, step_block, threads, smem_bytes(widths, step_block),
                batch * CLUSTER)


_ADDR_DTYPES = {torch.int16: 2, torch.int32: 4}
_VALUE_DTYPES = {torch.int8: 1, torch.float32: 4}


def _geometry(addrs: Tensor, counts: Tensor, layout: str):
    """(B, Tc, C, slot/step strides of the tables, of the counts)."""
    if layout == "slot_major":
        B, Tc, C = addrs.shape
        return B, Tc, C, (Tc * C, C), (Tc, 1)
    if layout == "time_major":
        Tc, B, C = addrs.shape
        return B, Tc, C, (C, B * C), (1, B)
    raise ValueError(f"unknown event layout {layout!r}")


def _check_modes(reset: str, kind: str, num_layers: int) -> None:
    if reset not in ("zero", "subtract"):
        raise ValueError(f"unknown reset mechanism {reset!r}")
    if kind not in ("lif", "lapicque"):
        raise ValueError(f"unknown neuron kind {kind!r}")
    if not 1 <= num_layers <= MAX_LAYERS:
        raise ValueError(f"snn_chunk supports 1..{MAX_LAYERS} layers")


def snn_chunk(
    weights: Sequence[Tensor],  # L x (K_i, N_i) f32
    biases: Sequence[Tensor],  # L x (N_i,) f32
    betas: Sequence[Tensor],  # L x (N_i,) f32 effective (post-sigmoid)
    thresholds: Sequence[Tensor],  # L x (N_i,) f32
    u0: Sequence[Tensor],  # L x (B, N_i) f32 incoming membranes
    r0: Sequence[Tensor],  # L x (B, N_i) i32 incoming refractory
    addrs: Tensor,  # (Tc, B, C) | (B, Tc, C) int16/int32 addresses
    values: Tensor,  # same shape, int8/f32 signed values (0 = pad)
    counts: Tensor,  # (Tc, B) | (B, Tc) int valid events per step
    active: Tensor,  # (B,) slot mask (nonzero = active)
    *,
    refractory_steps: int = 0,
    reset: str = "zero",
    kind: str = "lif",
    lapicque_gain: float = 1.0,
    layout: str = "time_major",
) -> ChunkResult:
    """Run the whole SNN ``Tc`` steps in one launch.

    Returns (out_mem (Tc, B, N_L), out_spikes (Tc, B, N_L), events
    (Tc, L, B), u_fin (L x (B, N_i)), refrac_fin (L x (B, N_i))).
    """
    if not addrs.is_cuda:
        return snn_chunk_ref(
            weights, biases, betas, thresholds, u0, r0, addrs, values,
            counts, active, refractory_steps=refractory_steps, reset=reset,
            kind=kind, lapicque_gain=lapicque_gain, layout=layout,
        )
    L = len(weights)
    _check_modes(reset, kind, L)
    dev = addrs.device
    B, Tc, C, ev_strides, cnt_strides = _geometry(addrs, counts, layout)
    if addrs.dtype not in _ADDR_DTYPES:
        raise TypeError(f"addrs must be int16 or int32, got {addrs.dtype}")
    if values.dtype not in _VALUE_DTYPES:
        raise TypeError(f"values must be int8 or float32, got {values.dtype}")
    if values.shape != addrs.shape:
        raise ValueError(f"values {tuple(values.shape)} != addrs {tuple(addrs.shape)}")
    want_counts = (B, Tc) if layout == "slot_major" else (Tc, B)
    if tuple(counts.shape) != want_counts:
        raise ValueError(f"counts {tuple(counts.shape)} != {want_counts}")
    widths = [int(weights[0].shape[0])] + [int(w.shape[1]) for w in weights]
    for i, w in enumerate(weights):
        if w.dim() != 2 or int(w.shape[0]) != widths[i]:
            raise ValueError(
                f"weights[{i}] {tuple(w.shape)} does not take layer "
                f"{i - 1}'s {widths[i]} outputs"
            )
    tensors = [*weights, *biases, *betas, *thresholds, *u0, *r0, values,
               counts, active]
    if any(t.device != dev for t in tensors):
        raise ValueError("snn_chunk: every tensor must be on the device of addrs")
    total = sum(widths[1:])
    geo = plan(widths, Tc, B)

    f32 = torch.float32
    ws = [w.to(f32).contiguous() for w in weights]
    bias = torch.cat([b.to(f32) for b in biases]).contiguous()
    beta = torch.cat([b.to(f32) for b in betas]).contiguous()
    thr = torch.cat([t.to(f32) for t in thresholds]).contiguous()
    u_in = torch.cat([u.to(f32) for u in u0], dim=1).contiguous()
    r_in = torch.cat([r.to(torch.int32) for r in r0], dim=1).contiguous()
    addrs = addrs.contiguous()
    values = values.contiguous()
    counts = counts.to(torch.int32).contiguous()
    act = (active != 0).to(torch.int32).contiguous()
    N_L = widths[-1]
    mem = torch.empty((Tc, B, N_L), dtype=f32, device=dev)
    spk = torch.empty((Tc, B, N_L), dtype=f32, device=dev)
    events = torch.empty((Tc, L, B), dtype=f32, device=dev)
    u_fin = torch.empty((B, total), dtype=f32, device=dev)
    r_fin = torch.empty((B, total), dtype=torch.int32, device=dev)

    from repro_torch.kernels import _build

    launch = _build.load("snn_chunk")
    w_ptrs = (ctypes.c_longlong * L)(*[w.data_ptr() for w in ws])
    w_dims = (ctypes.c_int * (L + 1))(*widths)
    rc = launch(
        w_ptrs, w_dims, L, bias.data_ptr(), beta.data_ptr(), thr.data_ptr(),
        u_in.data_ptr(), r_in.data_ptr(),
        addrs.data_ptr(), _ADDR_DTYPES[addrs.dtype],
        values.data_ptr(), _VALUE_DTYPES[values.dtype],
        counts.data_ptr(), act.data_ptr(),
        ev_strides[0], ev_strides[1], cnt_strides[0], cnt_strides[1],
        B, Tc, C, int(refractory_steps), int(reset == "subtract"),
        int(kind == "lapicque"), float(lapicque_gain),
        mem.data_ptr(), spk.data_ptr(), events.data_ptr(),
        u_fin.data_ptr(), r_fin.data_ptr(), geo.step_block, geo.threads,
        geo.smem,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"snn_chunk kernel launch failed: CUDA error {rc}")
    if torch.cuda.is_current_stream_capturing():
        snn_chunk.captured += 1  # recorded into a graph: runs at each replay
    else:
        snn_chunk.launches += 1
    offs = [sum(widths[1 : i + 1]) for i in range(L + 1)]
    u_out = tuple(u_fin[:, offs[i] : offs[i + 1]] for i in range(L))
    r_out = tuple(r_fin[:, offs[i] : offs[i + 1]] for i in range(L))
    return mem, spk, events, u_out, r_out


snn_chunk.launches = 0  # kernel launches since the last reset
# launches recorded into CUDA graphs being captured since the last reset; a
# graph launches each of them once per replay (the serving engine counts
# its replays)
snn_chunk.captured = 0


def snn_chunk_ref(
    weights: Sequence[Tensor],
    biases: Sequence[Tensor],
    betas: Sequence[Tensor],
    thresholds: Sequence[Tensor],
    u0: Sequence[Tensor],
    r0: Sequence[Tensor],
    addrs: Tensor,
    values: Tensor,
    counts: Tensor,
    active: Tensor,
    *,
    refractory_steps: int = 0,
    reset: str = "zero",
    kind: str = "lif",
    lapicque_gain: float = 1.0,
    layout: str = "time_major",
) -> ChunkResult:
    """Plain PyTorch version of ``snn_chunk`` on any device.

    Repeats the kernel's arithmetic step by step: layer 0 adds
    ``value * W0[addr]`` one event at a time in staging order, hidden
    layers add ``h[k] * W[k]`` for k ascending over nonzero h, each product
    and sum rounded separately.  Event entries past the step's count or
    with an address outside [0, K0) are skipped, as in the kernel.
    """
    L = len(weights)
    _check_modes(reset, kind, L)
    B, Tc, C, _, _ = _geometry(addrs, counts, layout)
    f32 = torch.float32
    if layout == "time_major":
        addrs, values, counts = (
            addrs.transpose(0, 1), values.transpose(0, 1), counts.transpose(0, 1)
        )
    a = addrs.long()  # advanced indexing takes int64, never int16
    v = values.to(f32)
    n_ev = counts.long().clamp(0, C)  # (B, Tc)
    live = (active != 0)[:, None]
    K0 = int(weights[0].shape[0])
    ok = (
        (torch.arange(C, device=a.device)[None, None, :] < n_ev[:, :, None])
        & (a >= 0)
        & (a < K0)
    )
    a = a.clamp(0, K0 - 1)
    u = [x.to(f32) for x in u0]
    r = [x.to(torch.int32) for x in r0]
    mems, spks, evs = [], [], []
    for t in range(Tc):
        ev_t = [n_ev[:, t].to(f32)]
        h = None
        for i in range(L):
            w = weights[i].to(f32)
            acc = torch.zeros((B, w.shape[1]), dtype=f32, device=w.device)
            if i == 0:
                for e in range(int(n_ev[:, t].max()) if B else 0):
                    term = v[:, t, e : e + 1] * w[a[:, t, e]]
                    acc = torch.where(ok[:, t, e : e + 1], acc + term, acc)
            else:
                ev_t.append(h.sum(dim=-1))
                for k in range(w.shape[0]):
                    hk = h[:, k : k + 1]
                    acc = torch.where(hk != 0, acc + hk * w[k], acc)
            cur = acc + biases[i].to(f32)
            if kind == "lif":
                u_pre = betas[i].to(f32) * u[i] + cur
            else:
                u_pre = u[i] + lapicque_gain * cur
            thr = thresholds[i].to(f32)
            spike = u_pre >= thr
            r_next = r[i]
            if refractory_steps > 0:
                spike = spike & (r[i] <= 0)
                r_next = torch.where(
                    spike,
                    torch.full_like(r[i], refractory_steps),
                    torch.clamp(r[i] - 1, min=0),
                )
            if reset == "zero":
                u_next = torch.where(spike, torch.zeros_like(u_pre), u_pre)
            else:
                u_next = torch.where(spike, u_pre - thr, u_pre)
            u[i] = torch.where(live, u_next, u[i])
            r[i] = torch.where(live, r_next, r[i])
            h = (spike & live).to(f32)
        mems.append(u[L - 1])
        spks.append(h)
        evs.append(torch.stack(ev_t) * live.T.to(f32))
    return (
        torch.stack(mems),
        torch.stack(spks),
        torch.stack(evs),
        tuple(u),
        tuple(r),
    )
