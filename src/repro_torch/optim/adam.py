"""Optimizers over trees of tensors: Adam (the paper's, lr 5e-4), AdamW
and SGD with momentum, behind one functional interface:

    opt = adam(5e-4)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

States are trees on the parameters' device; the step count is a 0-dim
int32 tensor there, so an update never reads the device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.tree import tree_leaves, tree_map

Tree = Any
LR = Union[float, Callable[[torch.Tensor], torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[..., Tuple[Tree, Tree]]


class AdamState(NamedTuple):
    count: torch.Tensor
    mu: Tree
    nu: Tree


def _zeros_like_tree(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _device_of(params: Tree) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def adam(lr: LR = 5e-4, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Adam (Kingma & Ba, bias-corrected; paper §4.2.1: lr 5e-4)."""

    def init(params):
        return AdamState(
            count=torch.zeros((), dtype=torch.int32, device=_device_of(params)),
            mu=_zeros_like_tree(params),
            nu=_zeros_like_tree(params),
        )

    def update(grads, state: AdamState, params=None):
        count = state.count + 1
        lr_t = lr(count) if callable(lr) else lr
        mu = tree_map(
            lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32), state.mu, grads
        )
        nu = tree_map(
            lambda v, g: b2 * v + (1 - b2) * torch.square(g.to(torch.float32)),
            state.nu, grads,
        )
        c1 = 1 - b1 ** count.to(torch.float32)
        c2 = 1 - b2 ** count.to(torch.float32)
        updates = tree_map(
            lambda m, v: -lr_t * (m / c1) / (torch.sqrt(v / c2) + eps), mu, nu
        )
        return updates, AdamState(count=count, mu=mu, nu=nu)

    return Optimizer(init=init, update=update)


def adamw(lr: LR = 1e-3, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    base = adam(lr, b1, b2, eps)

    def update(grads, state: AdamState, params=None):
        updates, state = base.update(grads, state, params)
        lr_t = lr(state.count) if callable(lr) else lr
        if params is not None and weight_decay:
            updates = tree_map(
                lambda u, p: u - lr_t * weight_decay * p.to(torch.float32),
                updates, params,
            )
        return updates, state

    return Optimizer(init=base.init, update=update)


class SGDState(NamedTuple):
    momentum: Tree


def sgd(lr: float = 1e-2, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return SGDState(momentum=_zeros_like_tree(params))

    def update(grads, state: SGDState, params=None):
        mom = tree_map(
            lambda m, g: momentum * m + g.to(torch.float32), state.momentum, grads
        )
        return tree_map(lambda m: -lr * m, mom), SGDState(momentum=mom)

    return Optimizer(init=init, update=update)


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(
        sum(torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree))
    )


def chain_clip(opt: Optimizer, max_norm: Optional[float] = 1.0) -> Optimizer:
    """Global-norm gradient clipping wrapper."""
    if max_norm is None:
        return opt

    def update(grads, state, params=None):
        scale = torch.clamp(max_norm / (global_norm(grads) + 1e-9), max=1.0)
        return opt.update(tree_map(lambda g: g * scale, grads), state, params)

    return Optimizer(init=opt.init, update=update)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)
