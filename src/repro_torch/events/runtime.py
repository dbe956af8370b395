"""Event-driven SNN forward pass over AER events.

Each step extracts the events (active input addresses) of a spike plane
and gathers only those weight rows into the synaptic integration, so work
scales with measured spiking activity.  Every entry point also measures
per-layer event counts, which feed ``core.energy.snn_ops_from_events``.

State is explicit (``init_states`` / ``run_chunk``) so the serving engine
can carry membrane potentials across chunks.  ``event_forward_aer`` runs
the network straight from an AER stream, every layer's current through
the aer kernel (``kernels.aer_matmul``).

Backends of ``run_chunk_events``:
  - ``"torch"``: plain PyTorch, the mirror of the reference's jnp scan
    (256-event gather chunks, ``step_events`` on hidden planes);
  - ``"fused"``: ``kernels.snn_chunk.snn_chunk`` — the CUDA kernel on a
    CUDA tensor, its plain version on a CPU tensor;
  - ``"fused_ref"``: ``kernels.snn_chunk.snn_chunk_ref`` on any device,
    the kernel's oracle;
  - ``"auto"``: ``"fused"`` on CUDA tensors, ``"torch"`` on the CPU.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import neuron, snn
from repro_torch.events import aer
from repro_torch.kernels import aer_matmul

Params = Dict[str, Dict[str, torch.Tensor]]
ChunkOut = Tuple[
    List[neuron.NeuronState], torch.Tensor, torch.Tensor, torch.Tensor
]


# --------------------------------------------------------------------------
# Per-step event extraction + gathered synaptic integration
# --------------------------------------------------------------------------


def step_events(
    x: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Extract the event list of one spike plane ``x`` (..., K).

    Returns (addrs (..., C) int32, values (..., C) float32, count (...,)
    int32), packed valid-first in ascending address order; ``values``
    carries the signed spike magnitude, 0 on padding.  A running count
    ranks each active position; the inverse map (which source position
    feeds output slot c) is a batched binary search over the monotone
    ranks.  At ``capacity`` the list keeps the *first* ``capacity``
    active positions.
    """
    K = x.shape[-1]
    lead = tuple(x.shape[:-1])
    dev = x.device
    active = x != 0
    pos = torch.cumsum(active.to(torch.int32), dim=-1, dtype=torch.int32)
    count = torch.clamp(pos[..., -1], max=capacity).to(torch.int32)
    R = math.prod(lead)
    targets = torch.arange(1, capacity + 1, dtype=torch.int32, device=dev)
    src = torch.searchsorted(
        pos.reshape(R, K).contiguous(),
        targets.expand(R, capacity).contiguous(),
        side="left",
    )
    src = torch.clamp(src, max=K - 1).reshape(lead + (capacity,))
    valid = torch.arange(capacity, device=dev) < count[..., None]
    addrs = torch.where(valid, src, 0).to(torch.int32)
    values = torch.where(valid, torch.gather(x, -1, src), 0.0)
    return addrs, values.to(torch.float32), count


def step_events_argsort(
    x: torch.Tensor, capacity: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``step_events`` by a stable argsort of the inactive mask (O(K log
    K)): the oracle of the compaction above, with the same outputs and
    the same truncation to the first ``capacity`` active positions."""
    active = x != 0
    order = torch.argsort(
        (~active).to(torch.uint8), dim=-1, stable=True
    )[..., :capacity]
    count = torch.clamp(active.sum(dim=-1), max=capacity).to(torch.int32)
    valid = torch.arange(order.shape[-1], device=x.device) < count[..., None]
    addrs = torch.where(valid, order, 0).to(torch.int32)
    values = torch.where(valid, torch.gather(x, -1, order), 0.0)
    if order.shape[-1] < capacity:  # capacity beyond K: pad the tail
        pad = (0, capacity - order.shape[-1])
        addrs = torch.nn.functional.pad(addrs, pad)
        values = torch.nn.functional.pad(values, pad)
    return addrs, values.to(torch.float32), count


def gather_current(
    w: torch.Tensor,  # (K, N) float weights
    b: torch.Tensor,  # (N,) float bias
    addrs: torch.Tensor,  # (B, C) int event addresses
    values: torch.Tensor,  # (B, C) float event values (0 = padding)
    *,
    chunk: int = 256,
) -> torch.Tensor:
    """Sum of gathered weight rows, in fixed event chunks so peak memory
    is (B, chunk, N) regardless of capacity."""
    B, C = addrs.shape
    acc = torch.zeros((B, w.shape[1]), dtype=torch.float32, device=w.device)
    for s in range(0, C, chunk):
        rows = w[addrs[:, s : s + chunk].long()]  # (B, chunk, N)
        acc = acc + torch.einsum("bc,bcn->bn", values[:, s : s + chunk], rows)
    return acc + b[None, :]


def encode_step_table(
    spikes: torch.Tensor,  # (..., T, K) dense spike train, integer-valued
    capacity: int,
    *,
    addr_dtype: Optional[torch.dtype] = None,
) -> aer.StepEventTable:
    """Compress a dense spike train into a packed per-step event table
    (int16/int32 addresses, int8 values, int32 counts).  Extraction is
    per-step independent, so slicing the table at step ``d`` equals
    extracting ``spikes[d]`` on the fly."""
    addrs, values, counts = step_events(spikes, capacity)
    if addr_dtype is None:
        addr_dtype = aer.addr_dtype_for(spikes.shape[-1])
    aer.check_addr_dtype(spikes.shape[-1], addr_dtype)
    return aer.StepEventTable(
        addrs=addrs.to(addr_dtype),
        values=values.to(torch.int8),
        counts=counts.to(torch.int32),
    )


# --------------------------------------------------------------------------
# Stateful chunk runner (shared by event_forward and the serving engine)
# --------------------------------------------------------------------------


def init_states(
    cfg: snn.SNNConfig, batch: int, device=None
) -> List[neuron.NeuronState]:
    return [
        neuron.init_state((batch, cfg.layer_sizes[i + 1]), device=device)
        for i in range(cfg.num_layers)
    ]


def prepare_params(params: Params, cfg: snn.SNNConfig) -> Params:
    """One-time parameter preparation: the config's Q1.15
    fake-quantization (a no-op otherwise).  Pass ``prepared=True`` to the
    chunk runners afterwards."""
    return snn.quantized(params) if cfg.quant_q115 else params


def run_chunk(
    params: Params,
    states: List[neuron.NeuronState],
    spikes: torch.Tensor,  # (Tc, B, K) input spike planes for this chunk
    cfg: snn.SNNConfig,
    *,
    active: Optional[torch.Tensor] = None,  # (B,) mask; inactive = frozen
    capacities: Optional[Sequence[int]] = None,
    prepared: bool = False,
    backend: str = "torch",
) -> ChunkOut:
    """Advance the network ``Tc`` steps event-drivenly.

    Returns (new_states, out_mem (Tc, B, N_L), out_spikes (Tc, B, N_L),
    events (Tc, n_layers, B)).  Layer-0 events are extracted once for the
    whole chunk and handed to ``run_chunk_events``.
    """
    B = spikes.shape[1]
    p = params if prepared else prepare_params(params, cfg)
    act = (
        torch.ones((B,), dtype=torch.float32, device=spikes.device)
        if active is None
        else active.to(torch.float32)
    )
    caps = _resolve_capacities(cfg, capacities)
    # silence frozen slots before extraction so counts match across backends
    addrs, values, counts = step_events(spikes * act[None, :, None], caps[0])
    return run_chunk_events(
        p, states, addrs, values, counts, cfg,
        active=act, capacities=caps, prepared=True, backend=backend,
    )


def run_chunk_events(
    params: Params,
    states: List[neuron.NeuronState],
    addrs: torch.Tensor,  # (Tc, B, C) int layer-0 addresses, valid-first
    values: torch.Tensor,  # (Tc, B, C) signed event values (0 = padding)
    counts: torch.Tensor,  # (Tc, B) int valid events per step
    cfg: snn.SNNConfig,
    *,
    active: Optional[torch.Tensor] = None,
    capacities: Optional[Sequence[int]] = None,
    prepared: bool = False,
    backend: str = "torch",
    layout: str = "time_major",  # "time_major" (Tc,B,C) | "slot_major" (B,Tc,C)
) -> ChunkOut:
    """``run_chunk`` over a pre-extracted layer-0 event table.

    Event lists must be packed valid-first with zero values on padding,
    already truncated to ``capacities[0]``, and silenced (zero values and
    counts) on frozen or out-of-window steps.
    """
    p = params if prepared else prepare_params(params, cfg)
    if layout == "slot_major":
        B = addrs.shape[0]
    elif layout == "time_major":
        B = addrs.shape[1]
    else:
        raise ValueError(f"unknown event layout {layout!r}")
    act = (
        torch.ones((B,), dtype=torch.float32, device=addrs.device)
        if active is None
        else active.to(torch.float32)
    )
    caps = _resolve_capacities(cfg, capacities)

    if backend == "auto":
        backend = "fused" if addrs.is_cuda else "torch"
    if backend in ("fused", "fused_ref"):
        return _run_chunk_fused(
            p, states, addrs, values, counts, cfg, act, caps,
            layout=layout, plain=backend == "fused_ref",
        )
    if backend != "torch":
        raise ValueError(f"unknown run_chunk backend {backend!r}")

    if layout == "slot_major":
        addrs = addrs.transpose(0, 1)
        values = values.transpose(0, 1)
        counts = counts.transpose(0, 1)
    ncfg = cfg.neuron_cfg
    live = act[:, None] > 0
    states = list(states)
    mems, spks, evs = [], [], []
    for a_t, v_t, c_t in zip(addrs, values, counts):
        ev_t = []
        h = None
        for i in range(cfg.num_layers):
            lp = p[f"layer{i}"]
            if i == 0:
                cur = gather_current(
                    lp["w"], lp["b"], a_t, v_t.to(torch.float32)
                )
                count = c_t.to(torch.float32)
            else:
                a_i, v_i, c_i = step_events(h, caps[i])
                cur = gather_current(lp["w"], lp["b"], a_i, v_i)
                count = c_i.to(torch.float32)
            st, spk = neuron.neuron_step(
                ncfg,
                states[i],
                cur,
                beta=snn.effective_beta(lp),
                threshold=lp["threshold"],
            )
            # frozen slots keep their previous membrane/refractory state
            states[i] = neuron.NeuronState(
                u=torch.where(live, st.u, states[i].u),
                refrac=torch.where(live, st.refrac, states[i].refrac),
            )
            h = spk * act[:, None]
            ev_t.append(count)
        mems.append(states[-1].u)
        spks.append(h)
        evs.append(torch.stack(ev_t))
    return states, torch.stack(mems), torch.stack(spks), torch.stack(evs)


def _resolve_capacities(
    cfg: snn.SNNConfig, capacities: Optional[Sequence[int]]
) -> List[int]:
    if capacities is None:
        return [int(cfg.layer_sizes[i]) for i in range(cfg.num_layers)]
    caps = [int(c) for c in capacities]
    if len(caps) != cfg.num_layers:
        raise ValueError(
            f"capacities has {len(caps)} entries for {cfg.num_layers} layers"
        )
    if any(c < 1 for c in caps):
        raise ValueError(f"capacities must be >= 1, got {caps}")
    return caps


def _run_chunk_fused(
    p, states, addrs, values, counts, cfg: snn.SNNConfig, act, caps,
    *, layout: str, plain: bool,
) -> ChunkOut:
    """Dispatch one chunk to the fused chunk (kernel, or its plain version
    when ``plain``).  It consumes packed valid-first tables as staged."""
    from repro_torch.kernels import snn_chunk as _chunk

    ncfg = cfg.neuron_cfg
    L = cfg.num_layers
    # the fused chunk truncates only the input event list; hidden layers
    # run as dense matvecs.  A truncating hidden capacity would make fused
    # and torch disagree for the same arguments, so reject it loudly.
    for i in range(1, L):
        if caps[i] < cfg.layer_sizes[i]:
            raise ValueError(
                f"backend='fused' cannot truncate hidden layers: "
                f"capacities[{i}]={caps[i]} < fan-in {cfg.layer_sizes[i]}. "
                f"Use full fan-in hidden capacities or backend='torch'."
            )
    layers = [p[f"layer{i}"] for i in range(L)]
    fn = _chunk.snn_chunk_ref if plain else _chunk.snn_chunk
    mem, spk, events, u_fin, r_fin = fn(
        [lp["w"] for lp in layers],
        [lp["b"] for lp in layers],
        [snn.effective_beta(lp) for lp in layers],
        [lp["threshold"] for lp in layers],
        [st.u for st in states],
        [st.refrac for st in states],
        addrs,
        values,
        counts,
        act,
        refractory_steps=ncfg.refractory_steps,
        reset=ncfg.reset,
        kind=ncfg.kind,
        lapicque_gain=ncfg.lapicque_gain,
        layout=layout,
    )
    new_states = [
        neuron.NeuronState(u=u, refrac=r) for u, r in zip(u_fin, r_fin)
    ]
    return new_states, mem, spk, events


# --------------------------------------------------------------------------
# Whole-window forward passes
# --------------------------------------------------------------------------


def event_forward(
    params: Params,
    spikes: torch.Tensor,  # (T, B, K) in {0,1}
    cfg: snn.SNNConfig,
    *,
    capacities: Optional[Sequence[int]] = None,
    prepared: bool = False,
    backend: str = "torch",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Event-driven analog of ``core.snn.forward`` (inference mode).

    Returns (out_mem (T,B,C), out_spikes (T,B,C), events (n_layers, B)).
    """
    states = init_states(cfg, spikes.shape[1], device=spikes.device)
    _, out_mem, out_spikes, events = run_chunk(
        params, states, spikes, cfg,
        capacities=capacities, prepared=prepared, backend=backend,
    )
    return out_mem, out_spikes, torch.sum(events, dim=0)


def step_windows(
    stream: aer.EventStream, num_steps: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The per-step event tables of a time-sorted AER stream with batch
    dims (B,): (addrs (T, B, E_max) int32, values (T, B, E_max) float32
    polarities, counts (T, B) float32), each step's window packed
    valid-first in stream order, ``E_max`` the longest window.

    A slot is valid inside its step's window and where its polarity is
    nonzero: ``merge`` without ``num_steps`` stamps padding at one past
    the latest time, which can fall inside the window, and padding must
    not be billed as events.  Sizing the tables reads one number back
    from the device (``E_max``), once per stream.
    """
    B, E = stream.times.shape
    dev = stream.times.device
    steps = torch.arange(num_steps + 1, dtype=stream.times.dtype, device=dev)
    bounds = torch.searchsorted(
        stream.times.contiguous(), steps.expand(B, -1).contiguous(),
        side="left",
    )  # (B, T + 1)
    start, end = bounds[:, :-1], bounds[:, 1:]
    e_max = max(1, int((end - start).max())) if B * num_steps else 1
    offs = start[:, :, None] + torch.arange(e_max, device=dev)  # (B, T, E_max)
    flat = offs.clamp(max=max(E - 1, 0)).reshape(B, -1)
    addrs = torch.gather(stream.addrs.long(), 1, flat).reshape(offs.shape)
    pol = torch.gather(stream.polarity, 1, flat).reshape(offs.shape)
    valid = (offs < end[:, :, None]) & (pol != 0)
    addrs = torch.where(valid, addrs, 0).to(torch.int32).transpose(0, 1)
    values = torch.where(valid, pol.to(torch.float32), 0.0).transpose(0, 1)
    counts = valid.sum(dim=-1).to(torch.float32).T
    return addrs.contiguous(), values.contiguous(), counts.contiguous()


def event_forward_aer(
    params: Params,
    stream: aer.EventStream,  # batch dims (B,), addresses over layer_sizes[0]
    cfg: snn.SNNConfig,
    *,
    num_steps: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run the SNN straight from an AER input stream (e.g. DVS events).

    No dense input plane is built: each step's window of the time-sorted
    stream is gathered into the synaptic integration, polarity-signed.
    Every layer's current is ``aer_matmul.aer_spike_matmul_batched``
    (the CUDA kernel on a CUDA tensor, its plain version on a CPU tensor)
    plus the bias: layer 0 over the step's window, hidden layers over
    ``step_events`` of the previous layer's spikes.  That is T x L kernel
    launches a window, issued after one host read (``step_windows``).

    Returns (out_mem (T, B, C), out_spikes (T, B, C), events (L, B)), the
    measured per-layer input events of the window.
    """
    T = num_steps if num_steps is not None else cfg.num_steps
    p = prepare_params(params, cfg)
    ncfg = cfg.neuron_cfg
    L = cfg.num_layers
    B = stream.times.shape[0]
    addrs, values, counts = step_windows(stream, T)
    states = init_states(cfg, B, device=stream.times.device)
    events = [torch.zeros_like(counts[0]) for _ in range(L)]
    mems, spks = [], []
    for t in range(T):
        h = None
        for i in range(L):
            lp = p[f"layer{i}"]
            if i == 0:
                a_i, v_i, count = addrs[t], values[t], counts[t]
            else:
                a_i, v_i, c_i = step_events(h, cfg.layer_sizes[i])
                count = c_i.to(torch.float32)
            cur = aer_matmul.aer_spike_matmul_batched(a_i, v_i, lp["w"]) + lp["b"]
            states[i], h = neuron.neuron_step(
                ncfg, states[i], cur,
                beta=snn.effective_beta(lp), threshold=lp["threshold"],
            )
            events[i] = events[i] + count
        mems.append(states[-1].u)
        spks.append(h)
    return torch.stack(mems), torch.stack(spks), torch.stack(events)


def predict_events(
    params: Params, spikes: torch.Tensor, cfg: snn.SNNConfig
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spike-count argmax prediction + measured events, event-driven."""
    out_mem, out_spikes, events = event_forward(params, spikes, cfg)
    return snn.predict_from_traces(out_mem, out_spikes), events
