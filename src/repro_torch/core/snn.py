"""The paper's SNN model (§4.2, Fig. 4): 4096 -> 512 LIF -> 2 LIF.

Parameters are a plain dict ``{"layer{i}": {"w", "b", "beta_raw",
"threshold"}}`` of tensors, the reference's layout: ``w`` is (fan_in,
fan_out), ``beta_raw`` is pre-sigmoid.  ``forward`` is the dense pass
(dropout on the hidden spikes in train mode); ``loss_fn`` is the membrane
cross-entropy that dense BPTT differentiates, the gradient-parity anchor
of the event-driven trainer (``sparse_train``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import coding, neuron, quant
from repro_torch.distributed.partitioning import laid_out_like

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    layer_sizes: Sequence[int] = (4096, 512, 2)  # paper Fig. 4
    num_steps: int = 25  # paper §4.2.1
    neuron_kind: str = "lif"  # "lif" | "lapicque"
    reset: str = "zero"
    surrogate: str = "atan"
    refractory_steps: int = 0  # 5 for the §4.2.2 variant
    dropout_rate: float = 0.2
    beta_init: float = 0.9
    threshold_init: float = 1.0
    quant_q115: bool = False  # fake-quant weights to Q1.15 on the fly

    @property
    def neuron_cfg(self) -> neuron.NeuronConfig:
        return neuron.NeuronConfig(
            kind=self.neuron_kind,
            reset=self.reset,
            surrogate=self.surrogate,
            refractory_steps=self.refractory_steps,
        )

    @property
    def num_layers(self) -> int:
        return len(self.layer_sizes) - 1


def _beta_raw_init(beta: float) -> float:
    beta = min(max(beta, 1e-4), 1 - 1e-4)
    return math.log(beta / (1 - beta))


def init_params(
    generator: torch.Generator, cfg: SNNConfig, device=None
) -> Params:
    """Kaiming-uniform linear layers + learnable per-layer beta/threshold.

    Draws on the generator's device, then moves to ``device``.
    """
    params: Params = {}
    for i, (fan_in, fan_out) in enumerate(
        zip(cfg.layer_sizes[:-1], cfg.layer_sizes[1:])
    ):
        bound = 1.0 / math.sqrt(fan_in)
        gdev = generator.device

        def uniform(shape):
            u = torch.rand(shape, generator=generator, device=gdev)
            return (u * 2.0 - 1.0) * bound

        params[f"layer{i}"] = {
            "w": uniform((fan_in, fan_out)).to(device),
            "b": uniform((fan_out,)).to(device),
            "beta_raw": torch.full(
                (fan_out,), _beta_raw_init(cfg.beta_init), device=device
            ),
            "threshold": torch.full(
                (fan_out,), float(cfg.threshold_init), device=device
            ),
        }
    return params


def params_from_numpy(
    params_np: Mapping[str, Mapping[str, np.ndarray]], device
) -> Params:
    """The reference's ``{layer{i}: {w, b, beta_raw, threshold}}`` as numpy
    arrays -> the port's float32 tensors on ``device``."""
    return {
        name: {
            k: torch.from_numpy(np.array(v, np.float32)).to(device)
            for k, v in lp.items()
        }
        for name, lp in params_np.items()
    }


def effective_beta(layer_params: Dict[str, torch.Tensor]) -> torch.Tensor:
    return torch.sigmoid(layer_params["beta_raw"])


def quantized(params: Params) -> Params:
    """Q1.15 fake-quantization of every layer's weights and biases."""
    return {
        name: {
            **lp,
            "w": quant.fake_quant(lp["w"], quant.Q1_15),
            "b": quant.fake_quant(lp["b"], quant.Q1_15),
        }
        for name, lp in params.items()
    }


def dropout(
    x: torch.Tensor, rate: float, generator: torch.Generator
) -> torch.Tensor:
    """Inverted dropout: keep each entry with probability ``1 - rate``
    and scale the kept ones by ``1 / (1 - rate)``.  The draws come from
    ``generator``, which must live on ``x``'s device."""
    u = laid_out_like(lambda shape: torch.rand(
        shape, generator=generator, dtype=x.dtype, device=x.device), x)
    return apply_dropout(x, u, rate)


def apply_dropout(x: torch.Tensor, u: torch.Tensor, rate: float) -> torch.Tensor:
    """``dropout`` on uniforms ``u`` (x's shape) drawn ahead of time, so a
    captured step draws nothing: equal to ``dropout`` bit for bit when
    ``u`` holds the draw it would make."""
    keep = (u < 1.0 - rate).to(x.dtype)
    return x * keep / (1.0 - rate)


def forward(
    params: Params,
    spikes: torch.Tensor,  # (T, B, input_size) in {0,1}
    cfg: SNNConfig,
    *,
    train: bool = False,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run the SNN over the coding window.

    In train mode with ``cfg.dropout_rate > 0`` the first layer's spikes
    go through ``dropout``, one mask per step drawn from ``generator``.
    Returns (out_mem (T, B, n_class), out_spikes (T, B, n_class)).
    """
    ncfg = cfg.neuron_cfg
    p = quantized(params) if cfg.quant_q115 else params
    drop = train and cfg.dropout_rate > 0.0
    if drop and generator is None:
        raise ValueError("a generator is required when train=True")
    B = spikes.shape[1]
    states = [
        neuron.init_state(
            (B, cfg.layer_sizes[i + 1]), device=spikes.device
        )
        for i in range(cfg.num_layers)
    ]
    out_mem, out_spikes = [], []
    for x_t in spikes:
        h = x_t
        for i in range(cfg.num_layers):
            lp = p[f"layer{i}"]
            cur = h @ lp["w"] + lp["b"]
            states[i], h = neuron.neuron_step(
                ncfg,
                states[i],
                cur,
                beta=effective_beta(lp),
                threshold=lp["threshold"],
            )
            if i == 0 and drop:
                h = dropout(h, cfg.dropout_rate, generator)
        out_mem.append(states[-1].u)
        out_spikes.append(h)
    return torch.stack(out_mem), torch.stack(out_spikes)


def membrane_ce_loss(out_mem: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Cross-entropy on the output membrane trace (T, B, C), summed over
    all time steps and averaged over the batch (paper: 'Cross-entropy
    loss is computed across all time steps, summing up to form the total
    loss')."""
    logp = torch.log_softmax(out_mem, dim=-1)
    onehot = torch.nn.functional.one_hot(labels.long(), out_mem.shape[-1])
    ce_per_step = -torch.sum(onehot.to(logp.dtype)[None] * logp, dim=-1)
    return torch.mean(torch.sum(ce_per_step, dim=0))


def predict_from_traces(
    out_mem: torch.Tensor, out_spikes: torch.Tensor
) -> torch.Tensor:
    """Spike-count argmax over the window (snntorch convention),
    tie-broken by membrane sum so all-zero-spike batches still predict."""
    counts = torch.sum(out_spikes, dim=0)  # (B, C)
    return torch.argmax(counts + 1e-6 * torch.sum(out_mem, dim=0), dim=-1)


def loss_fn(
    params: Params,
    spikes: torch.Tensor,  # (T, B, input_size)
    labels: torch.Tensor,  # (B,) int class labels
    cfg: SNNConfig,
    *,
    train: bool = True,
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Membrane cross-entropy loss (see ``membrane_ce_loss``) + metrics."""
    out_mem, out_spikes = forward(
        params, spikes, cfg, train=train, generator=generator
    )
    loss = membrane_ce_loss(out_mem, labels)
    pred = predict_from_traces(out_mem, out_spikes)
    acc = torch.mean((pred == labels).to(torch.float32))
    return loss, {"accuracy": acc, "spike_rate": torch.mean(out_spikes)}


def predict(
    params: Params,
    images: torch.Tensor,
    cfg: SNNConfig,
    generator: torch.Generator,
) -> torch.Tensor:
    """End-to-end inference: rate-encode (draws from ``generator``, which
    must live on the images' device) + forward + spike-count argmax."""
    flat = images.reshape(images.shape[0], -1)
    spikes = coding.rate_encode(generator, flat, cfg.num_steps)
    out_mem, out_spikes = forward(params, spikes, cfg, train=False)
    return predict_from_traces(out_mem, out_spikes)


def hidden_spike_rates(
    params: Params, spikes: torch.Tensor, cfg: SNNConfig
) -> torch.Tensor:
    """Mean per-layer spike rates (n_layers,), which feed the event-driven
    energy model (``energy.snn_inference_ops``).  Runs the float weights,
    as the reference does, whatever ``cfg.quant_q115`` says."""
    ncfg = cfg.neuron_cfg
    B = spikes.shape[1]
    states = [
        neuron.init_state((B, n), device=spikes.device)
        for n in cfg.layer_sizes[1:]
    ]
    rates = []
    for x_t in spikes:
        h, step_rates = x_t, []
        for i in range(cfg.num_layers):
            lp = params[f"layer{i}"]
            cur = h @ lp["w"] + lp["b"]
            states[i], h = neuron.neuron_step(
                ncfg, states[i], cur,
                beta=effective_beta(lp), threshold=lp["threshold"],
            )
            step_rates.append(torch.mean(h))
        rates.append(torch.stack(step_rates))
    return torch.mean(torch.stack(rates), dim=0)
