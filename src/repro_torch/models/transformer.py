"""Block assembly: the layer plan and execution over layer-stacked params.

Every architecture reduces to a *layer plan*: a repeating pattern of
blocks whose params are stacked over the repeat dimension (the
reference's layout), plus an optional non-divisible tail group.

  dense/vlm/audio : pattern [(gqa|mla, mlp)]            x num_layers
  moe             : pattern [(gqa, moe)]                x num_layers
  first_k_dense   : [(mla, dense_mlp)] x k, then [(mla, moe)] x the rest
                    (DeepSeek-V2: groups "dense" and "main")
  ssm             : pattern [(ssm, None)]               x num_layers
  hybrid(griffin) : pattern [(rg,mlp),(rg,mlp),(gqa,mlp)] x repeats + tail

Blocks are pre-norm residual:  x += mixer(norm(x)); x += ffn(norm(x)).
The reference scans the repeat dimension; here a group loops over it,
each layer reading views of the stacked params and caches, and in
training each repeat is checkpointed as ``cfg.remat`` says.  Caches are
stacked the same way; decode writes them in place.
"""

from __future__ import annotations

import functools
from typing import Any, List, Optional, Tuple

import torch
from torch.utils.checkpoint import (
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from repro_torch.distributed.partitioning import (constrain, pad,
                                                  unshard_batch_axes)
from repro_torch.models import attention, griffin, layers, moe, ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Tree = Any


def dequant_block_params(p: Tree) -> Tree:
    """Per-layer on-the-fly dequant of int-stored weights (serving quant
    modes): int16 codes are Q1.15, int8 codes Q1.7, both to bfloat16.
    Called inside each layer so only one layer's float weights are live."""

    def deq(x):
        if x.dtype == torch.int16:
            return x.to(torch.bfloat16) * (2 ** -15)
        if x.dtype == torch.int8:
            return x.to(torch.bfloat16) * (2 ** -7)
        return x

    return tree_map(deq, p)


# ================================================================ plan
def layer_plan(cfg: ModelConfig) -> List[Tuple[str, List[Tuple[str, Optional[str]]], int]]:
    """Returns [(group_name, pattern, repeats)]; sum(len(pattern)*repeats)
    == num_layers."""
    if cfg.family == "ssm":
        pattern = [("ssm", None)]
    elif cfg.family == "hybrid":
        pattern = [
            ("rg", "mlp") if k == "rg" else ("gqa", "mlp")
            for k in (cfg.block_pattern or ("rg", "rg", "attn"))
        ]
    else:
        mixer = "mla" if cfg.mla else "gqa"
        ffn = "moe" if cfg.num_experts else "mlp"
        pattern = [(mixer, ffn)]
        if cfg.first_k_dense:
            # DeepSeek-V2: leading dense blocks, then the expert blocks
            return [("dense", [(mixer, "dense_mlp")], cfg.first_k_dense),
                    ("main", pattern, cfg.num_layers - cfg.first_k_dense)]
    n = len(pattern)
    repeats, rem = divmod(cfg.num_layers, n)
    plan = []
    if repeats:
        plan.append(("main", pattern, repeats))
    if rem:
        plan.append(("tail", pattern[:rem], 1))
    return plan


# ================================================================ blocks
def _mixer_init(init: Init, cfg: ModelConfig, kind: str):
    if kind == "gqa":
        return attention.gqa_init(init, cfg)
    if kind == "mla":
        return attention.mla_init(init, cfg)
    if kind == "ssm":
        return ssm.ssm_init(init, cfg)
    if kind == "rg":
        return griffin.rglru_block_init(init, cfg)
    raise ValueError(kind)


def block_init(init: Init, cfg: ModelConfig, spec: Tuple[str, Optional[str]]):
    mixer_kind, ffn_kind = spec
    p = {
        "norm1": layers.norm_init(init, cfg.d_model, cfg.norm_kind),
        "mixer": _mixer_init(init, cfg, mixer_kind),
    }
    if ffn_kind is not None:
        p["norm2"] = layers.norm_init(init, cfg.d_model, cfg.norm_kind)
        if ffn_kind == "moe":
            p["ffn"] = (moe.dropless_init(init, cfg) if cfg.moe_dropless
                        else moe.moe_init(init, cfg))
        elif ffn_kind == "dense_mlp":
            p["ffn"] = layers.mlp_init(init, cfg.d_model,
                                       cfg.dense_d_ff or cfg.d_ff,
                                       cfg.mlp_kind)
        else:
            p["ffn"] = layers.mlp_init(init, cfg.d_model, cfg.d_ff,
                                       cfg.mlp_kind)
    return p


def _apply_ffn(p, h, cfg: ModelConfig, ffn_kind):
    if ffn_kind == "moe":
        if cfg.moe_dropless:
            return moe.dropless_forward(p["ffn"], h, cfg)
        return moe.moe_forward(p["ffn"], h, cfg)
    return layers.apply_mlp(p["ffn"], h, cfg.mlp_kind), {}


def _ffn_residual(p, x, cfg: ModelConfig, ffn_kind):
    if ffn_kind is None:
        return x, {}
    # the mixer's output projection leaves a DTensor partial sum over the
    # model axis; it is reduced here, as GSPMD reduces it at the product,
    # or the FFN's products would gather their weights to keep it partial
    x = constrain(x, ("batch", "act_seq", "embed_act"))
    h = layers.apply_norm(p["norm2"], x, cfg.norm_kind, cfg.norm_eps)
    out, aux = _apply_ffn(p, h, cfg, ffn_kind)
    return x + out, aux


def block_forward(p, x, positions, cfg: ModelConfig, spec):
    """Training / no-cache forward.  Returns (x, aux)."""
    mixer_kind, ffn_kind = spec
    p = unshard_batch_axes(dequant_block_params(p))
    x = constrain(x, ("batch", "act_seq", "embed_act"))
    h = layers.apply_norm(p["norm1"], x, cfg.norm_kind, cfg.norm_eps)
    if mixer_kind == "gqa":
        mx = attention.gqa_forward(p["mixer"], h, positions, cfg)
    elif mixer_kind == "mla":
        mx = attention.mla_forward(p["mixer"], h, positions, cfg)
    elif mixer_kind == "ssm":
        mx = ssm.ssm_forward(p["mixer"], h, cfg)
    elif mixer_kind == "rg":
        mx = griffin.rglru_block_forward(p["mixer"], h, cfg)
    else:
        raise ValueError(mixer_kind)
    return _ffn_residual(p, x + mx, cfg, ffn_kind)


def block_prefill(p, x, positions, cfg: ModelConfig, spec, cache_len):
    """Forward + populate this block's decode cache."""
    mixer_kind, ffn_kind = spec
    p = unshard_batch_axes(dequant_block_params(p))
    x = constrain(x, ("batch", "act_seq", "embed_act"))
    h = layers.apply_norm(p["norm1"], x, cfg.norm_kind, cfg.norm_eps)
    if mixer_kind == "gqa":
        mx, cache = attention.gqa_prefill(p["mixer"], h, positions, cfg,
                                          cache_len)
    elif mixer_kind == "mla":
        mx, cache = attention.mla_prefill(p["mixer"], h, positions, cfg,
                                          cache_len)
    elif mixer_kind == "ssm":
        mx, state = ssm.ssm_forward(p["mixer"], h, cfg, return_state=True)
        cache = _ssm_prefill_cache(p["mixer"], h, state, cfg)
    elif mixer_kind == "rg":
        mx, cache = griffin.rglru_block_forward(p["mixer"], h, cfg,
                                                return_state=True)
    else:
        raise ValueError(mixer_kind)
    x, _ = _ffn_residual(p, x + mx, cfg, ffn_kind)
    return x, cache


def _ssm_prefill_cache(pm, h, state, cfg: ModelConfig):
    """The ssm decode cache after a prefill over h: the last W-1 *pre-
    activation* stream values of each conv, and the SSD state."""
    W = cfg.ssm_conv_width
    xs, Bs, Cs = ssm._streams(pm, h)

    def tail(t):
        return pad(t, (0, 0, W - 1, 0))[:, -(W - 1):, :]

    return {"conv_x": tail(xs), "conv_B": tail(Bs), "conv_C": tail(Cs),
            "state": state}


def block_decode(p, x, pos, cache, cfg: ModelConfig, spec):
    """One token through the block; ``cache`` is updated in place."""
    mixer_kind, ffn_kind = spec
    p = unshard_batch_axes(dequant_block_params(p))
    x = constrain(x, ("batch", "act_seq", "embed_act"))
    h = layers.apply_norm(p["norm1"], x, cfg.norm_kind, cfg.norm_eps)
    if mixer_kind == "gqa":
        mx, cache = attention.gqa_decode(p["mixer"], h, pos, cache, cfg)
    elif mixer_kind == "mla":
        mx, cache = attention.mla_decode(p["mixer"], h, pos, cache, cfg)
    elif mixer_kind == "ssm":
        mx, cache = ssm.ssm_decode(p["mixer"], h, cache, cfg)
    elif mixer_kind == "rg":
        mx, cache = griffin.rglru_block_decode(p["mixer"], h, cache, cfg)
    else:
        raise ValueError(mixer_kind)
    x, _ = _ffn_residual(p, x + mx, cfg, ffn_kind)
    return x, cache


def block_cache_init(cfg: ModelConfig, spec, batch, cache_len, dtype,
                     device=None):
    mixer_kind, _ = spec

    def z(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    if mixer_kind == "gqa":
        ring = attention._is_ring(cfg)
        S = min(cfg.window, cache_len) if ring else cache_len
        shape = (batch, S, cfg.num_kv_heads, cfg.head_dim)
        if cfg.kv_cache_quant:
            return {"k": z(shape, torch.int8), "v": z(shape, torch.int8),
                    "k_scale": z(shape[:3]), "v_scale": z(shape[:3])}
        return {"k": z(shape), "v": z(shape)}
    if mixer_kind == "mla":
        return {"c_kv": z((batch, cache_len, cfg.kv_lora_rank)),
                "k_rope": z((batch, cache_len, cfg.qk_rope_head_dim))}
    if mixer_kind == "ssm":
        return ssm.ssm_cache_init(cfg, batch, dtype, device)
    if mixer_kind == "rg":
        return griffin.rglru_cache_init(cfg, batch, dtype, device)
    raise ValueError(mixer_kind)


# ================================================================ stacks
def group_init(init: Init, cfg: ModelConfig, pattern, repeats: int):
    """Init one plan group: dict b0..b{k-1}, each stacked over repeats."""
    stacked = init.stacked(repeats)
    return {f"b{i}": block_init(stacked, cfg, spec)
            for i, spec in enumerate(pattern)}


def _repeats(gp) -> int:
    return tree_leaves(gp)[0].shape[0]


def _layer(tree, r: int):
    return tree_map(lambda t: t[r], tree)


def _unbound(gp) -> List[Tree]:
    """The group's params, one tree a repeat, as the views of one
    ``unbind`` of each stacked leaf: its backward stacks the repeats'
    gradients in one write, where a view by index would fill a zero
    tensor of the stacked leaf's size for every repeat."""
    cols = [t.unbind(0) for t in tree_leaves(gp)]
    return [tree_unflatten(gp, [c[r] for c in cols])
            for r in range(_repeats(gp))]


_DOTS = ("mm", "bmm", "addmm", "baddbmm")


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat``, the reference's ``jax.checkpoint`` of one
    repeat: "full" saves only its inputs and recomputes the rest in the
    backward; "dots" saves the matmul outputs (``checkpoint_dots``) and
    recomputes the rest; "none" saves everything.  It applies only under
    autograd.  No random draw happens in a repeat, so the generator's
    state is not saved (its read could not run inside a CUDA graph)."""
    if cfg.remat == "none":
        return fn
    if cfg.remat == "dots":
        ops = [getattr(torch.ops.aten, name).default for name in _DOTS]
        context_fn = functools.partial(create_selective_checkpoint_contexts,
                                       ops)
    else:
        context_fn = noop_context_fn

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False, context_fn=context_fn)

    return wrapped


def group_forward(gp, x, positions, cfg: ModelConfig, pattern):
    """Loop over the group's repeat dim, each repeat under ``cfg.remat``.
    Returns (x, summed aux)."""

    def body(h, lp):
        aux_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        for i, spec in enumerate(pattern):
            h, aux = block_forward(lp[f"b{i}"], h, positions, cfg, spec)
            if "moe_aux_loss" in aux:
                aux_sum = aux_sum + aux["moe_aux_loss"]
        return h, aux_sum

    body = _remat(body, cfg)
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in _unbound(gp):
        x, aux = body(x, lp)
        total = total + aux
    return x, total


def group_prefill(gp, x, positions, cfg: ModelConfig, pattern, cache_len):
    caches = []
    for r in range(_repeats(gp)):
        lp = _layer(gp, r)
        layer_caches = {}
        for i, spec in enumerate(pattern):
            x, layer_caches[f"b{i}"] = block_prefill(
                lp[f"b{i}"], x, positions, cfg, spec, cache_len
            )
        caches.append(layer_caches)
    return x, tree_map(lambda *ts: torch.stack(ts), *caches)


def group_decode(gp, x, pos, caches, cfg: ModelConfig, pattern):
    """One token through the group; the stacked caches are written in
    place through per-layer views and returned."""
    for r in range(_repeats(gp)):
        lp = _layer(gp, r)
        cr = _layer(caches, r)
        for i, spec in enumerate(pattern):
            x, _ = block_decode(lp[f"b{i}"], x, pos, cr[f"b{i}"], cfg, spec)
    return x, caches


def group_cache_init(cfg: ModelConfig, pattern, repeats, batch, cache_len,
                     dtype, device=None):
    caches = {}
    for i, spec in enumerate(pattern):
        one = block_cache_init(cfg, spec, batch, cache_len, dtype, device)
        caches[f"b{i}"] = tree_map(
            lambda t: torch.zeros((repeats, *t.shape), dtype=t.dtype,
                                  device=t.device), one
        )
    return caches
