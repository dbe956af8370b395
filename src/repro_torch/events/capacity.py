"""Event-capacity autotuning from measured spike-count percentiles.

The event hot path stages a fixed per-step event-list capacity per
layer.  Full fan-in is safe but pays for silence: at ~10-15 % input rates
most of a 4096-slot list is padding that the chunk still stages.  This
module picks capacities from **measured** per-step event counts:

  1. ``measure_step_counts`` runs the chunk path over a representative
     sample and collects every (step, row) event count per layer.
  2. ``autotune`` sets each layer's capacity to a percentile of that
     distribution times a safety factor, aligned up to ``align`` and
     clipped to fan-in.  The ``CapacityPlan`` carries the observed tails
     and the implied truncation.
  3. ``truncation_report`` replays the sample at the tuned capacities and
     untruncated, and reports prediction agreement, output drift and the
     fraction of events dropped.

At ``percentile=100`` with ``safety > 1`` the plan is lossless on the
sample.  The defaults are the reference's, so the plans equal its plans;
``align`` stays 128 although ``kernels.snn_chunk`` stages events in
blocks of 512.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import snn
from repro_torch.events import runtime

__all__ = [
    "CapacityPlan",
    "input_capacity",
    "measure_step_counts",
    "autotune",
    "truncation_report",
]


def input_capacity(
    cfg: snn.SNNConfig, capacities: Optional[Sequence[int]] = None
) -> int:
    """Layer-0 per-step event-list capacity: the explicit plan's first
    entry, full fan-in otherwise.  Validated as ``run_chunk`` validates
    ``capacities``, so a bad plan fails at engine init."""
    return runtime._resolve_capacities(cfg, capacities)[0]


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    """Per-layer event-list capacities + the evidence they rest on."""

    capacities: Tuple[int, ...]  # chosen per-layer capacity
    fan_in: Tuple[int, ...]  # layer fan-in (the untuned default)
    percentile: float
    safety: float
    align: int
    max_count: Tuple[int, ...]  # observed max per-step count
    pct_count: Tuple[float, ...]  # observed count at `percentile`
    # fraction of (step, row) event lists that would exceed capacity
    truncated_lists_frac: Tuple[float, ...]
    # fraction of total events that would be dropped
    dropped_events_frac: Tuple[float, ...]

    @property
    def shrink(self) -> Tuple[float, ...]:
        """Capacity reduction vs fan-in, per layer (e.g. 6.4 = 6.4x)."""
        return tuple(
            f / c if c else float("nan")
            for f, c in zip(self.fan_in, self.capacities)
        )

    def as_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["shrink"] = list(self.shrink)
        return d


def measure_step_counts(
    params,
    cfg: snn.SNNConfig,
    spikes: torch.Tensor,  # (T, B, K) representative sample
    *,
    prepared: bool = False,
    backend: str = "torch",
) -> np.ndarray:
    """Measured per-step, per-row event counts: (n_layers, T*B) int, read
    off the device in one transfer.  ``backend`` is ``run_chunk``'s."""
    states = runtime.init_states(cfg, spikes.shape[1], device=spikes.device)
    _, _, _, events = runtime.run_chunk(
        params, states, spikes, cfg, prepared=prepared, backend=backend
    )
    ev = events.cpu().numpy()  # (T, L, B)
    return ev.transpose(1, 0, 2).reshape(ev.shape[1], -1)


def autotune(
    params,
    cfg: snn.SNNConfig,
    spikes: torch.Tensor,  # (T, B, K) representative sample
    *,
    percentile: float = 100.0,
    safety: float = 1.25,
    align: int = 128,
    prepared: bool = False,
    tune_hidden: bool = False,
    counts: Optional[np.ndarray] = None,  # reuse a prior measurement
) -> CapacityPlan:
    """Pick per-layer capacities from measured spike-count percentiles.

    ``tune_hidden=False`` (default) pins hidden-layer capacities at full
    fan-in so the plan is valid for every ``run_chunk`` backend: the fused
    chunk runs hidden layers dense and refuses a truncating hidden
    capacity.  Layer 0, the widest, is always tuned.  Pass ``counts``
    from ``measure_step_counts`` to tune on another backend's counts.
    """
    if counts is None:
        counts = measure_step_counts(params, cfg, spikes, prepared=prepared)
    caps, maxes, pcts, trunc, dropped = [], [], [], [], []
    for i in range(cfg.num_layers):
        fan_in = int(cfg.layer_sizes[i])
        c_i = counts[i]
        p = float(np.percentile(c_i, percentile)) if c_i.size else 0.0
        if i > 0 and not tune_hidden:
            cap = fan_in
        else:
            cap = int(math.ceil(p * safety))
            cap = max(
                align, int(math.ceil(cap / max(align, 1)) * max(align, 1))
            )
            cap = min(cap, fan_in)
        caps.append(cap)
        maxes.append(int(c_i.max()) if c_i.size else 0)
        pcts.append(p)
        trunc.append(float(np.mean(c_i > cap)) if c_i.size else 0.0)
        total = float(c_i.sum())
        dropped.append(
            float(np.maximum(c_i - cap, 0).sum()) / total if total else 0.0
        )
    return CapacityPlan(
        capacities=tuple(caps),
        fan_in=tuple(int(s) for s in cfg.layer_sizes[:-1]),
        percentile=float(percentile),
        safety=float(safety),
        align=int(align),
        max_count=tuple(maxes),
        pct_count=tuple(pcts),
        truncated_lists_frac=tuple(trunc),
        dropped_events_frac=tuple(dropped),
    )


def truncation_report(
    params,
    cfg: snn.SNNConfig,
    spikes: torch.Tensor,  # (T, B, K) evaluation sample
    plan: CapacityPlan,
    *,
    prepared: bool = False,
    backend: str = "torch",
) -> Dict:
    """Measure what the tuned capacities cost on a sample: the window
    replayed untruncated and at ``plan.capacities``, compared in
    predictions, output membrane drift and measured event totals.
    ``backend`` is ``event_forward``'s (the reference's ``"jnp"`` is the
    port's ``"torch"``)."""
    full_m, full_s, full_ev = runtime.event_forward(
        params, spikes, cfg, prepared=prepared, backend=backend
    )
    trunc_m, trunc_s, trunc_ev = runtime.event_forward(
        params, spikes, cfg, capacities=plan.capacities,
        prepared=prepared, backend=backend,
    )
    pred_full = snn.predict_from_traces(full_m, full_s)
    pred_trunc = snn.predict_from_traces(trunc_m, trunc_s)
    # everything the report reads, off the device in one transfer
    f64 = torch.float64  # repro-lint: disable=RL106 -- report totals for the host, read once; no kernel sees them
    host = torch.stack([
        (pred_full == pred_trunc).to(f64).mean(),
        (trunc_m - full_m).abs().max().to(f64),
        (trunc_s.sum(0) - full_s.sum(0)).abs().max().to(f64),
        full_ev.to(f64).sum(),
        trunc_ev.to(f64).sum(),
    ]).cpu().tolist()
    agree, drift, spike_diff, ev_full, ev_trunc = host
    return {
        "capacities": list(plan.capacities),
        "pred_agreement": agree,
        "out_mem_max_abs_diff": drift,
        "out_spike_count_max_abs_diff": spike_diff,
        "events_full": ev_full,
        "events_truncated": ev_trunc,
        "events_dropped_frac": (
            (ev_full - ev_trunc) / ev_full if ev_full else 0.0
        ),
    }
