"""Shared pieces of the SNN examples: the device flag and the training
loop of the reference examples (Adam lr 5e-4, global-norm clip 1.0,
membrane cross-entropy summed over steps, dropout from the config)."""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core import coding, snn
from repro_torch.data import collision
from repro_torch.optim import adam, chain_clip
from repro_torch.optim.adam import apply_updates
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

# encode(generator, flat images (B, K), num_steps) -> spikes (T, B, K)
Encoder = Callable[[torch.Generator, torch.Tensor, int], torch.Tensor]


def add_device_flag(ap) -> None:
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never falls back")


def train_step_fn(cfg: snn.SNNConfig, encode: Encoder, gen: torch.Generator):
    """(params, opt_state, x, y) -> (params, opt_state, loss, aux): one
    eager step of Adam over the config's training loss."""
    opt = chain_clip(adam(5e-4), 1.0)

    def step(params, opt_state, x, y):
        spikes = encode(gen, x, cfg.num_steps)
        live = tree_map(lambda p: p.detach().requires_grad_(True), params)
        with torch.enable_grad():
            loss, aux = snn.loss_fn(live, spikes, y, cfg, train=True,
                                    generator=gen)
            # a Lapicque network leaves beta unused: its gradient is 0
            grads = torch.autograd.grad(loss, tree_leaves(live),
                                        materialize_grads=True)
        with torch.no_grad():
            updates, opt_state = opt.update(
                tree_unflatten(params, list(grads)), opt_state, params)
            params = apply_updates(params, updates)
        aux = {k: v.detach() for k, v in aux.items()}
        return params, opt_state, loss.detach(), aux

    return opt, step


def train(
    cfg: snn.SNNConfig,
    trx: np.ndarray,
    trY: np.ndarray,
    *,
    epochs: int,
    batch: int,
    seed: int,
    device: torch.device,
    encode: Encoder,
    log: Optional[Callable[[int, float, float], None]] = None,
):
    """Train from a seeded init for ``epochs`` epochs of ``batch``; returns
    (params, generator).  ``log(epoch, loss, accuracy)`` after each epoch
    (one device read an epoch)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = snn.init_params(torch.Generator().manual_seed(seed), cfg, device)
    opt, step = train_step_fn(cfg, encode, gen)
    opt_state = opt.init(params)
    for epoch in range(epochs):
        loss = aux = None
        for x, y in collision.batches(trx, trY, batch, seed=epoch,
                                      device=device):
            params, opt_state, loss, aux = step(params, opt_state, x, y)
        if log is not None and loss is not None:
            log(epoch, float(loss), float(aux["accuracy"]))
    return params, gen


def evaluate(params, cfg: snn.SNNConfig, x: np.ndarray, y: np.ndarray,
             encode: Encoder, gen: torch.Generator, device: torch.device):
    """(test accuracy, the encoded test spikes (T, B, K))."""
    flat = torch.as_tensor(x.reshape(len(x), -1)).to(device)
    spikes = encode(gen, flat, cfg.num_steps)
    _, aux = snn.loss_fn(params, spikes, torch.as_tensor(y).to(device), cfg,
                         train=False)
    return float(aux["accuracy"]), spikes


def rate(gen: torch.Generator, x: torch.Tensor, num_steps: int) -> torch.Tensor:
    """Bernoulli rate coding, the paper's code (an ``Encoder``)."""
    return coding.rate_encode(gen, x, num_steps)
