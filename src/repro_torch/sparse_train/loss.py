"""Energy-aware training objective for the event-driven SNN.

    L = CE(out_mem, labels)  +  energy_lambda * E_hat[nJ]

``E_hat`` prices the network's differentiable spike activity with the
per-event energies of the measured model (``core.energy``): each spike a
hidden layer emits costs its downstream fan-out in accumulator adds plus
the weight fetches.  Gradients reach the spike counts through the
surrogate backward, so raising ``energy_lambda`` trades accuracy for
sparsity along the paper's energy axis.

Every step also reports measured per-layer event counts and their energy
(the tensor form of ``snn_ops_from_events(...).energy_pj()``) as metrics.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import snn
from repro_torch.core.energy import ENERGY_PJ
from repro_torch.sparse_train import event_layer

Tensor = torch.Tensor


def event_cost_pj(fan_out: int, *, weight_bits: int = 16) -> float:
    """Energy (pJ) of one input event at a layer with ``fan_out`` outputs:
    one accumulator add per output + the SRAM weight fetches."""
    wpl = 64 // weight_bits
    return fan_out * (ENERGY_PJ["add_i32"] + ENERGY_PJ["sram_64b"] / wpl)


def measured_energy_pj(
    layer_sizes: Sequence[int],
    num_steps: int,
    events_per_layer: Tensor,  # (n_layers,) or (n_layers, B) measured counts
    *,
    weight_bits: int = 16,
    neuron_kind: str = "lif",
) -> Tensor:
    """Tensor form of ``core.energy.snn_ops_from_events(...).energy_pj()``,
    so the measured energy stays on the device inside a train step."""
    ev = torch.as_tensor(events_per_layer, dtype=torch.float32)
    total = torch.zeros(ev.shape[1:], dtype=torch.float32, device=ev.device)
    wpl = 64 // weight_bits
    for i, fan_out in enumerate(layer_sizes[1:]):
        total = total + ev[i] * fan_out * ENERGY_PJ["add_i32"]
        fixed = num_steps * fan_out * (
            ENERGY_PJ["add_i32"]  # bias add
            + (ENERGY_PJ["mul_i16"] if neuron_kind == "lif" else 0.0)
            + ENERGY_PJ["add_i16"]
            + ENERGY_PJ["cmp_i16"]
        )
        total = total + fixed
        total = total + ev[i] * fan_out / wpl * ENERGY_PJ["sram_64b"]
    return total + ev[0] / 2.0 * ENERGY_PJ["sram_64b"]


def energy_regularizer_nj(
    layer_sizes: Sequence[int],
    act: Tensor,  # (n_layers,) differentiable mean spikes per layer output
    *,
    weight_bits: int = 16,
) -> Tensor:
    """Differentiable downstream-event energy (nJ per inference).

    ``act[i]`` spikes emitted by layer i each land on layer i+1 and cost
    ``event_cost_pj(fan_out_{i+1})``; the last layer's spikes leave the
    chip and are priced free.  Input-layer events are data and carry no
    gradient (they are still in the measured metric).
    """
    total = torch.zeros((), dtype=torch.float32, device=act.device)
    fan_outs = list(layer_sizes[1:])
    for i in range(len(fan_outs) - 1):
        total = total + act[i] * event_cost_pj(
            fan_outs[i + 1], weight_bits=weight_bits
        )
    return total / 1e3  # pJ -> nJ keeps the loss term O(1)


def event_loss_fn(
    params,
    spikes: Tensor,  # (T, B, K)
    labels: Tensor,  # (B,)
    cfg: snn.SNNConfig,
    *,
    energy_lambda: float = 0.0,
    train: bool = True,
    generator: Optional[torch.Generator] = None,
    capacity: Optional[int] = None,
    use_kernel: bool = False,
    dropout_u: Optional[Tensor] = None,
) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Event-driven analog of ``core.snn.loss_fn`` + energy objective.

    With ``energy_lambda == 0`` the loss and its gradient match the dense
    ``snn.loss_fn`` to float tolerance.  Dropout draws from ``generator``
    or takes the pre-drawn ``dropout_u`` (``event_bptt_forward``).
    Metrics are detached 0-dim tensors on the device; reading them is the
    caller's sync.
    """
    out_mem, out_spikes, events, act = event_layer.event_bptt_forward(
        params,
        spikes,
        cfg,
        train=train,
        generator=generator,
        capacity=capacity,
        use_kernel=use_kernel,
        dropout_u=dropout_u,
    )
    task_loss = snn.membrane_ce_loss(out_mem, labels)
    energy_nj = energy_regularizer_nj(cfg.layer_sizes, act)
    loss = task_loss + energy_lambda * energy_nj

    with torch.no_grad():
        pred = snn.predict_from_traces(out_mem, out_spikes)
        ev_mean = torch.mean(events, dim=-1)  # (n_layers,) per inference
        metrics: Dict[str, Tensor] = {
            "task_loss": task_loss.detach(),
            "energy_reg_nj": energy_nj.detach(),
            "accuracy": torch.mean((pred == labels).to(torch.float32)),
            "spike_rate": torch.mean(out_spikes),
            "hidden_rate": act[0] / (cfg.num_steps * cfg.layer_sizes[1]),
            "energy_pj": measured_energy_pj(
                cfg.layer_sizes, cfg.num_steps, ev_mean,
                neuron_kind=cfg.neuron_kind,
            ),
        }
        for i in range(events.shape[0]):
            metrics[f"events_l{i}"] = ev_mean[i]
    return loss, metrics
