"""Optimizers over trees of tensors: Adam (the paper's, lr 5e-4), AdamW
and SGD with momentum, behind one functional interface:

    opt = adam(5e-4)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

States are trees on the parameters' device; the step count is a 0-dim
int32 tensor there, so an update never reads the device.

Each of them is written leaf by leaf (``Leafwise``): ``update`` maps the
leaf rule over the trees, and ``update_into`` runs it one leaf at a time
into buffers, so a step holds one leaf's temporaries instead of a tree of
each (the static training step of a full-width LM).  Both run the same
operations on every element in the same order, so they agree bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Tree = Any
LR = Union[float, Callable[[torch.Tensor], torch.Tensor]]


class Leafwise(NamedTuple):
    """An update computed one leaf at a time.

    ``begin(grads, state) -> ctx``: the values every leaf shares (step
    count, learning rate, clipping scale).  Only ``chain_clip`` reads
    ``grads`` (their global norm); a rule wrapped in another gets None.
    ``leaf(ctx, g, p, slots) -> (update, new_slots)``: one leaf's update
    and its new per-leaf state, ``slots`` being its leaves of
    ``slot_trees(state)`` (``p`` is None where no params are given).
    ``end(ctx, state, new_slot_trees) -> state``: the new state.
    """

    begin: Callable[[Any, Tree], Any]
    leaf: Callable[..., Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]]
    slot_trees: Callable[[Tree], Tuple[Tree, ...]]
    end: Callable[[Any, Tree, Tuple[Tree, ...]], Tree]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    #: the update's leaf rule (``update`` over trees, ``update_into``)
    leafwise: Leafwise

    def update(self, grads: Tree, state: Tree,
               params: Optional[Tree] = None) -> Tuple[Tree, Tree]:
        """``(updates, new_state)``: the leaf rule mapped over the trees."""
        lw = self.leafwise
        ctx = lw.begin(grads, state)
        gs = tree_leaves(grads)
        ps = tree_leaves(params) if params is not None else [None] * len(gs)
        old = lw.slot_trees(state)
        slots = [tree_leaves(t) for t in old]
        updates, new = [], [[] for _ in old]
        for i, g in enumerate(gs):
            u, ns = lw.leaf(ctx, g, ps[i], tuple(s[i] for s in slots))
            updates.append(u)
            for acc, n in zip(new, ns):
                acc.append(n)
        new_trees = tuple(tree_unflatten(t, n) for t, n in zip(old, new))
        return tree_unflatten(grads, updates), lw.end(ctx, state, new_trees)


class AdamState(NamedTuple):
    count: torch.Tensor
    mu: Tree
    nu: Tree


def _zeros_like_tree(params: Tree) -> Tree:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _device_of(params: Tree) -> torch.device:
    leaves = tree_leaves(params)
    return leaves[0].device if leaves else torch.device("cpu")


def _adam_leafwise(lr: LR, b1: float, b2: float, eps: float,
                   weight_decay: float = 0.0) -> Leafwise:
    """Adam's rule; with ``weight_decay``, AdamW's decoupled decay of the
    update (applied where params are given)."""

    def begin(grads, state: AdamState):
        count = state.count + 1
        lr_t = lr(count) if callable(lr) else lr
        c1 = 1 - b1 ** count.to(torch.float32)
        c2 = 1 - b2 ** count.to(torch.float32)
        return count, lr_t, c1, c2

    def leaf(ctx, g, p, slots):
        _, lr_t, c1, c2 = ctx
        m, v = slots
        g32 = g.to(torch.float32)
        mu = b1 * m + (1 - b1) * g32
        nu = b2 * v + (1 - b2) * torch.square(g32)
        u = -lr_t * (mu / c1) / (torch.sqrt(nu / c2) + eps)
        if p is not None and weight_decay:
            u = u - lr_t * weight_decay * p.to(torch.float32)
        return u, (mu, nu)

    def end(ctx, state, new):
        return AdamState(count=ctx[0], mu=new[0], nu=new[1])

    return Leafwise(begin, leaf, lambda s: (s.mu, s.nu), end)


def _adam_init(params):
    return AdamState(
        count=torch.zeros((), dtype=torch.int32, device=_device_of(params)),
        mu=_zeros_like_tree(params),
        nu=_zeros_like_tree(params),
    )


def adam(lr: LR = 5e-4, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    """Adam (Kingma & Ba, bias-corrected; paper §4.2.1: lr 5e-4)."""
    return Optimizer(_adam_init, _adam_leafwise(lr, b1, b2, eps))


def adamw(lr: LR = 1e-3, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    return Optimizer(_adam_init,
                     _adam_leafwise(lr, b1, b2, eps, weight_decay))


class SGDState(NamedTuple):
    momentum: Tree


def sgd(lr: float = 1e-2, momentum: float = 0.9) -> Optimizer:
    def init(params):
        return SGDState(momentum=_zeros_like_tree(params))

    def leaf(ctx, g, p, slots):
        mom = momentum * slots[0] + g.to(torch.float32)
        return -lr * mom, (mom,)

    return Optimizer(init, Leafwise(
        begin=lambda grads, state: None, leaf=leaf,
        slot_trees=lambda s: (s.momentum,),
        end=lambda ctx, state, new: SGDState(momentum=new[0])))


def global_norm(tree: Tree) -> torch.Tensor:
    return torch.sqrt(
        sum(torch.sum(torch.square(x.to(torch.float32))) for x in tree_leaves(tree))
    )


def chain_clip(opt: Optimizer, max_norm: Optional[float] = 1.0) -> Optimizer:
    """Global-norm gradient clipping wrapper.  The norm is of the step's
    whole gradient, so the clip goes outside any rule that changes the
    gradients leaf by leaf: ``chain_clip(compressed(opt))``."""
    if max_norm is None:
        return opt
    inner = opt.leafwise

    def begin(grads, state):
        if grads is None:
            raise ValueError("chain_clip inside another optimizer's leaf "
                             "rule: wrap the clip around it instead")
        scale = torch.clamp(max_norm / (global_norm(grads) + 1e-9), max=1.0)
        return scale, inner.begin(None, state)

    def leaf(ctx, g, p, slots):
        scale, inner_ctx = ctx
        return inner.leaf(inner_ctx, g * scale, p, slots)

    return Optimizer(opt.init, Leafwise(
        begin=begin, leaf=leaf, slot_trees=inner.slot_trees,
        end=lambda ctx, state, new: inner.end(ctx[1], state, new)))


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def update_into(opt: Optimizer, grads: List[Optional[torch.Tensor]],
                state: Tree, params: Tree,
                out: Optional[Tuple[Tree, Tree]]) -> None:
    """``opt``'s step of ``params`` (the update, then ``apply_updates``),
    leaf by leaf into ``out``, a ``(params, state)`` pair of trees of
    buffers that may be ``params`` and ``state`` themselves: each leaf is
    written after its last read.  ``grads`` are the gradient leaves in
    walk order; the list is consumed (each entry dropped once used), so a
    step holds one leaf's temporaries at a time.  ``out=None`` computes
    every leaf and drops it (a warm-up that changes no buffer)."""
    # imported here: the distributed package imports this module
    from repro_torch.distributed import partitioning

    lw = opt.leafwise
    ctx = lw.begin(grads, state)
    slots = [tree_leaves(t) for t in lw.slot_trees(state)]
    if out is not None:
        out_ps = tree_leaves(out[0])
        out_slots = [tree_leaves(t) for t in lw.slot_trees(out[1])]
    for i, p in enumerate(tree_leaves(params)):
        g, grads[i] = grads[i], None
        leaf = (ctx, g, p, tuple(s[i] for s in slots),
                None if out is None else
                (out_ps[i], tuple(bufs[i] for bufs in out_slots)))
        if partitioning.is_dtensor(p):
            # the update is elementwise: each device updates its own block
            leaf = partitioning.local_leaves(
                (ctx, partitioning.constrain_like(g, p), *leaf[2:]))
        c, g, p_, s_, bufs = leaf
        u, ns = lw.leaf(c, g, p_, s_)
        new_p = p_ + u.to(p_.dtype)
        if bufs is not None:
            bufs[0].copy_(new_p)
            for buf, n in zip(bufs[1], ns):
                buf.copy_(n)
        del g, u, ns, new_p, leaf, c, p_, s_, bufs
    if out is not None:
        new_state = lw.end(ctx, state, lw.slot_trees(out[1]))
        for buf, x in zip(tree_leaves(out[1]), tree_leaves(new_state)):
            if buf is not x:
                buf.copy_(x)
