"""Mixture-of-Experts: top-k router + grouped-capacity einsum dispatch.

Gshard-style dispatch/combine einsums over *token groups*: tokens are
flattened batch-major into groups of ``moe_group_size``; capacity is per
group, C = ceil(Gs * k / E * cf).  Overflow tokens are dropped (zero
combine weight; the residual passes them through), so every shape is
fixed by the token count and the config, as in the reference.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.partitioning import (constrain, merge_dims,
                                                  run_local, unflatten)
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init


def moe_init(init: Init, cfg: ModelConfig):
    E, Fd, N = cfg.d_model, cfg.d_ff, cfg.num_experts
    scale = 1.0 / math.sqrt(E)
    fscale = 1.0 / math.sqrt(Fd)
    return {
        "router": layers.dense_init(init, (E, N), ("embed", "expert")),
        "w_gate": init.uniform((N, E, Fd), -scale, scale,
                               axes=("expert", "embed", "mlp")),
        "w_up": init.uniform((N, E, Fd), -scale, scale,
                             axes=("expert", "embed", "mlp")),
        "w_down": init.uniform((N, Fd, E), -fscale, fscale,
                               axes=("expert", "mlp", "embed")),
    }


def group_size(cfg: ModelConfig, tokens: int) -> int:
    gs = min(cfg.moe_group_size, tokens)
    while tokens % gs:
        gs -= 1
    return gs


def capacity(gs: int, cfg: ModelConfig) -> int:
    c = math.ceil(
        gs * cfg.num_experts_per_tok / cfg.num_experts * cfg.capacity_factor
    )
    return max(int(c), 1)


def router_weights(logits: torch.Tensor,
                   cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k routing -> (weights (..., k) float32, indices (..., k))."""
    k = cfg.num_experts_per_tok
    if cfg.router_softmax_order == "topk_then_softmax":
        vals, idx = torch.topk(logits, k, dim=-1)
        w = torch.softmax(vals.float(), dim=-1)
    else:  # softmax_then_topk (granite)
        probs = torch.softmax(logits.float(), dim=-1)
        w, idx = torch.topk(probs, k, dim=-1)
        w = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1e-9)
    return w, idx


def _experts(xg, dispatch, combine, w_up, w_gate, w_down, mlp_kind: str):
    """Each expert's MLP on its capacity slots, combined back per token:
    (G, Gs, D) -> (G, Gs, D)."""
    xe = torch.einsum("gsec,gsd->gecd", dispatch, xg)  # (G, E, C, D)
    xe = constrain(xe, ("batch", "expert", "cap", "embed_act"))
    h_up = torch.einsum("gecd,edf->gecf", xe, w_up)
    if mlp_kind in ("swiglu", "geglu"):
        h_gate = torch.einsum("gecd,edf->gecf", xe, w_gate)
        act = F.silu if mlp_kind == "swiglu" else layers.gelu
        h = act(h_gate) * h_up
    else:
        h = layers.gelu(h_up)
    h = constrain(h, ("batch", "expert", "cap", "mlp"))
    ye = torch.einsum("gecf,efd->gecd", h, w_down)
    ye = constrain(ye, ("batch", "expert", "cap", "embed_act"))
    return torch.einsum("gecd,gsec->gsd", ye, combine)  # (G, Gs, D)


def moe_forward(p, x: torch.Tensor,
                cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, E) -> (out (B, S, E), aux metrics)."""
    B, S, D = x.shape
    N = cfg.num_experts
    T = B * S
    Gs = group_size(cfg, T)
    G = T // Gs
    C = capacity(Gs, cfg)
    # batch-major flatten: sharding propagates
    xg = unflatten(merge_dims(x, 0, 1), 0, (G, Gs))
    xg = constrain(xg, ("batch", "act_seq", "embed_act"))

    logits = xg @ p["router"].to(x.dtype)  # (G, Gs, N)
    w, idx = router_weights(logits, cfg)  # (G, Gs, K) f32 / int

    # queue position of each (token, slot) within its expert, per group
    onehot = F.one_hot(idx, N).to(torch.int32)  # (G, Gs, K, N)
    flat = onehot.reshape(G, -1, N)
    pos_flat = torch.cumsum(flat, dim=1, dtype=torch.int32) - flat
    pos = torch.sum(pos_flat.reshape(onehot.shape) * onehot, dim=-1)
    keep = pos < C  # (G, Gs, K)
    slot_oh = F.one_hot(torch.clamp(pos, max=C - 1).long(), C).to(x.dtype)
    slot_oh = slot_oh * keep[..., None].to(x.dtype)  # (G, Gs, K, C)

    dispatch = torch.einsum(
        "gske,gskc->gsec", onehot.to(x.dtype), slot_oh
    )  # (G, Gs, E, C)
    combine = torch.einsum(
        "gske,gskc,gsk->gsec", onehot.float(), slot_oh.float(), w
    ).to(x.dtype)

    w_gate = (p["w_gate"].to(x.dtype)
              if cfg.mlp_kind in ("swiglu", "geglu") else None)
    # over DTensors each device runs the experts of its shard on its groups
    # and sums their part of each token's output (partial over experts)
    experts = ("expert", None, None)
    out = run_local(
        functools.partial(_experts, mlp_kind=cfg.mlp_kind),
        (xg, dispatch, combine, p["w_up"].to(x.dtype), w_gate,
         p["w_down"].to(x.dtype)),
        (("batch", None, None), ("batch", None, "expert", None),
         ("batch", None, "expert", None), experts,
         None if w_gate is None else experts, experts),
        xg.shape, ("batch", None, None), summed=(1, 2))  # (G, Gs, D)
    # DTensor has no rule to unflatten a group dim sharded two ways, in
    # either direction: both sides of the reshape are laid out explicitly
    out = constrain(out, ("batch", "act_seq", "embed_act"))
    out = constrain(unflatten(merge_dims(out, 0, 1), 0, (B, S)),
                    ("batch", "act_seq", "embed_act"))

    # load-balancing auxiliaries (Switch aux loss)
    me = torch.mean(onehot.float().sum(2).reshape(T, N), dim=0)
    pe = torch.mean(torch.softmax(logits.float(), -1).reshape(T, N), dim=0)
    aux = {
        "moe_aux_loss": N * torch.sum(me * pe),
        "moe_dropped_frac": 1.0 - torch.mean(keep.float()),
    }
    return out, aux
