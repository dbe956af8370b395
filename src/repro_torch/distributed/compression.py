"""Gradient compression with error feedback (data-parallel all-reduce).

The counterpart of the reference's ``repro.distributed.compression``:
int8 quantize -> all-reduce -> dequantize with *error feedback* (Seide et
al. 2014; 1-bit-Adam lineage): the quantization residual is carried into
the next step, so convergence matches uncompressed SGD/Adam to first
order.  Gradients are coded per tensor (symmetric max-scale int8), 4x
fewer bytes on the wire than float32.  Codes and scales are the
reference's bit for bit on the same float32 arrays.

Usage: wrap the optimizer --
    opt = compressed(adam(1e-3), group=dist.group.WORLD)
or use ``compress_tree`` directly around a manual all-reduce.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.optim.adam import Leafwise, Optimizer
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Tree = Any


class CompressedState(NamedTuple):
    inner: Any
    error: Tree  # error-feedback residual, same structure as grads


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (codes, scale)."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    codes = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return codes, scale


def dequantize_int8(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(torch.float32) * scale


def _compress(g: torch.Tensor, e: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One leaf: (dequantized g + e, the new residual)."""
    g32 = g.to(torch.float32) + e
    d = dequantize_int8(*quantize_int8(g32))
    return d, g32 - d


def compress_tree(grads: Tree, error: Tree) -> Tuple[Tree, Tree]:
    """Quantize (grads + carried error); returns (quantized_float, new_error).

    The returned tree is float32 (already dequantized) so it can feed any
    all-reduce; the wire format in a real deployment is (codes, scale).
    """
    pairs = [_compress(g, e)
             for g, e in zip(tree_leaves(grads), tree_leaves(error))]
    return (tree_unflatten(grads, [d for d, _ in pairs]),
            tree_unflatten(grads, [r for _, r in pairs]))


def compressed(opt: Optimizer, group: Optional[Any] = None) -> Optimizer:
    """Error-feedback int8 compression in front of an optimizer, leaf by
    leaf: compress a leaf (plus its carried error), reduce it, then the
    inner rule on it; the residual is one more slot beside the inner's.

    With a ``torch.distributed`` process ``group`` the compressed grads are
    averaged over it (``all_reduce``, then divided by its size), as the
    reference's ``pmean`` over a mesh axis; with None the caller does the
    reduction, as the reference's ``psum_axis=None``.  A global-norm clip
    goes outside: ``chain_clip(compressed(opt))``.
    """
    inner = opt.leafwise

    def init(params):
        err = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
        return CompressedState(inner=opt.init(params), error=err)

    def leaf(ctx, g, p, slots):
        d, err = _compress(g, slots[-1])
        if group is not None:
            dist.all_reduce(d, group=group)
            d.div_(dist.get_world_size(group))
        u, ns = inner.leaf(ctx, d, p, slots[:-1])
        return u, (*ns, err)

    return Optimizer(init, Leafwise(
        begin=lambda grads, state: inner.begin(None, state.inner),
        leaf=leaf,
        slot_trees=lambda s: (*inner.slot_trees(s.inner), s.error),
        end=lambda ctx, state, new: CompressedState(
            inner=inner.end(ctx, state.inner, new[:-1]), error=new[-1])))
