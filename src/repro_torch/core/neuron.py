"""LIF and Lapicque neuron dynamics (paper §3.1, Eqs. 1-2/4).

  Lapicque (Eq. 1):  U[t+1] = U[t] + (T/C) * I[t]
  LIF      (Eq. 2):  U[t+1] = beta*U[t] + I[t+1] - R*(beta*U[t] + I[t+1])

On a spike (U >= U_thr) the membrane resets to zero, or by subtraction of
the threshold.  ``refractory_steps`` suppresses firing for that many steps
after each spike via a per-neuron countdown (paper §4.2.2).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import surrogate


@dataclasses.dataclass(frozen=True)
class NeuronConfig:
    """Static neuron hyperparameters (learnables live in the params)."""

    kind: str = "lif"  # "lif" | "lapicque"
    reset: str = "zero"  # "zero" | "subtract"
    surrogate: str = "atan"
    refractory_steps: int = 0  # 0 = disabled; paper uses 5 when enabled
    lapicque_gain: float = 1.0  # T/C of Eq. 1; ignored for LIF

    def spike_fn(self) -> Callable[[torch.Tensor], torch.Tensor]:
        return surrogate.get(self.surrogate)


class NeuronState(NamedTuple):
    """Per-neuron dynamic state threaded through time."""

    u: torch.Tensor  # membrane potential
    refrac: torch.Tensor  # int32 refractory countdown


def init_state(
    shape: Tuple[int, ...], dtype=torch.float32, device=None
) -> NeuronState:
    return NeuronState(
        u=torch.zeros(shape, dtype=dtype, device=device),
        refrac=torch.zeros(shape, dtype=torch.int32, device=device),
    )


def neuron_step(
    cfg: NeuronConfig,
    state: NeuronState,
    current: torch.Tensor,
    *,
    beta: torch.Tensor,
    threshold: torch.Tensor,
) -> Tuple[NeuronState, torch.Tensor]:
    """One time-step of membrane dynamics.  Returns (new_state, spikes)."""
    spike_fn = cfg.spike_fn()

    if cfg.kind == "lif":
        u_pre = beta * state.u + current
    elif cfg.kind == "lapicque":
        u_pre = state.u + cfg.lapicque_gain * current
    else:
        raise ValueError(f"unknown neuron kind {cfg.kind!r}")

    raw_spk = spike_fn(u_pre - threshold)

    if cfg.refractory_steps > 0:
        can_fire = (state.refrac <= 0).to(u_pre.dtype)
        spk = raw_spk * can_fire
        refrac_next = torch.where(
            spk > 0,
            torch.full_like(state.refrac, cfg.refractory_steps),
            torch.clamp(state.refrac - 1, min=0),
        )
    else:
        spk = raw_spk
        refrac_next = state.refrac

    if cfg.reset == "zero":
        # Eq. 2: U[t+1] = u_pre - R * u_pre
        u_next = u_pre - u_pre.detach() * spk
    elif cfg.reset == "subtract":
        u_next = u_pre - threshold * spk
    else:
        raise ValueError(f"unknown reset mechanism {cfg.reset!r}")

    return NeuronState(u=u_next, refrac=refrac_next), spk


def run_neuron(
    cfg: NeuronConfig,
    currents: torch.Tensor,  # (T, ...) input current per step
    *,
    beta: torch.Tensor,
    threshold: torch.Tensor,
    init: Optional[NeuronState] = None,
) -> Tuple[torch.Tensor, NeuronState]:
    """Run ``neuron_step`` over the leading time axis.

    Returns (spikes (T, ...), final_state).
    """
    state = init
    if state is None:
        state = init_state(
            tuple(currents.shape[1:]), currents.dtype, currents.device
        )
    spikes = []
    for cur in currents:
        state, spk = neuron_step(
            cfg, state, cur, beta=beta, threshold=threshold
        )
        spikes.append(spk)
    return torch.stack(spikes), state


def membrane_trace(
    cfg: NeuronConfig,
    currents: torch.Tensor,  # (T, ...) input current per step
    *,
    beta: torch.Tensor,
    threshold: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Like ``run_neuron`` from rest, but also returns the membrane
    potential after each step: (spikes (T, ...), u (T, ...)).

    Used for losses computed on output-layer membrane potentials
    (cross-entropy summed across time steps, paper §4.2.1) and for the
    Fig.-1-style membrane visualisations."""
    state = init_state(tuple(currents.shape[1:]), currents.dtype,
                       currents.device)
    spikes, us = [], []
    for cur in currents:
        state, spk = neuron_step(
            cfg, state, cur, beta=beta, threshold=threshold
        )
        spikes.append(spk)
        us.append(state.u)
    return torch.stack(spikes), torch.stack(us)
