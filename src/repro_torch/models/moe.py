"""Mixture-of-Experts: top-k router + grouped-capacity einsum dispatch.

Gshard-style dispatch/combine einsums over *token groups*: tokens are
flattened batch-major into groups of ``moe_group_size``; capacity is per
group, C = ceil(Gs * k / E * cf).  Overflow tokens are dropped (zero
combine weight; the residual passes them through), so every shape is
fixed by the token count and the config, as in the reference.

``cfg.moe_dropless`` (DeepSeek-V2) takes the other layer here,
``dropless_forward``: no capacity, so no token is dropped and a token's
output never depends on its neighbours, with shapes still fixed by the
token count and the config (see there).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.partitioning import (constrain, merge_dims,
                                                  run_local, unflatten)
from repro_torch.kernels import markers
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init


def moe_init(init: Init, cfg: ModelConfig):
    E, Fd, N = cfg.d_model, cfg.d_ff, cfg.num_experts
    scale = 1.0 / math.sqrt(E)
    fscale = 1.0 / math.sqrt(Fd)
    return {
        # the router scores all ``router_experts`` where only some are held
        "router": layers.dense_init(init, (E, cfg.router_experts or N),
                                    ("embed", "expert")),
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
    else:  # softmax_then_topk (granite), softmax_then_topk_raw (deepseek)
        probs = torch.softmax(logits.float(), dim=-1)
        w, idx = torch.topk(probs, k, dim=-1)
        if cfg.router_softmax_order != "softmax_then_topk_raw":
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


# ============================================================ dropless
def dropless_init(init: Init, cfg: ModelConfig):
    """``moe_init``'s router and held experts, and the shared experts as
    one MLP of width ``num_shared_experts * d_ff``."""
    p = moe_init(init, cfg)
    if cfg.num_shared_experts:
        p["shared"] = layers.mlp_init(init, cfg.d_model,
                                      cfg.num_shared_experts * cfg.d_ff,
                                      cfg.mlp_kind)
    return p


# routed (token, held expert) pairs each held expert has taken on a
# device, summed on the device by every dropless layer (prefill and decode
# alike, inside the engine's graphs), and the totals last published
_LOAD: Dict[Tuple[str, int], torch.Tensor] = {}
_PUBLISHED: Dict[Tuple[str, int], List[int]] = {}


def _device_key(device) -> str:
    """``device`` by name, a card's index made explicit (``cuda`` is the
    current card's)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return str(d)


def _count_load(counts: torch.Tensor) -> None:
    """Add one layer's pairs per held expert to its device's running
    totals (allocated at the first, eager, call: never inside a
    capture)."""
    if counts.device.type == "meta":
        return
    key = (_device_key(counts.device), counts.shape[0])
    load = _LOAD.get(key)
    if load is None:
        load = _LOAD[key] = torch.zeros_like(counts, dtype=torch.int64)
    load.add_(counts)


def publish_expert_load(registry, device) -> List[int]:
    """Read each held expert's routed pairs on ``device`` (one device read)
    and add what each took since the last publish to ``registry``'s
    counters ``moe.routed_pairs.e<i>`` (an ``obs.metrics``
    ``MetricsRegistry``); returns those increments."""
    out: List[int] = []
    for key, load in _LOAD.items():
        if key[0] != _device_key(device):
            continue
        now = [int(v) for v in load.cpu().tolist()]
        last = _PUBLISHED.get(key, [0] * len(now))
        _PUBLISHED[key] = now
        out = [a - b for a, b in zip(now, last)]
        for i, d in enumerate(out):
            registry.counter(f"moe.routed_pairs.e{i}").inc(d)
    return out


def _routed(xt, router, w_gate, w_up, w_down, cfg: ModelConfig):
    """The held experts' part of ``xt``'s (T, D) outputs: (T, D) float32.

    Every token is routed over all ``router_experts`` (float32 scores);
    its (token, expert) pairs whose expert is held here are sorted by
    expert into a buffer of T * min(k, held) rows, which holds every held
    pair whatever the routing, with each expert's end offset on the
    device; one grouped product an MLP weight runs the rows up to the
    last offset, so the work follows the pairs routed here; the rows come
    back to their pairs' places and each token sums its pairs, weighted.
    Pairs whose expert is held elsewhere add nothing here."""
    T, N, k = xt.shape[0], cfg.num_experts, cfg.num_experts_per_tok
    w, idx = router_weights(xt.float() @ router.float(), cfg)  # (T, k)
    local = idx - cfg.expert_offset
    held = (local >= 0) & (local < N)
    key = torch.where(held, local, N).reshape(-1)  # (T * k,) N: elsewhere
    counts = torch.zeros(N + 1, dtype=torch.int64, device=xt.device)
    counts.scatter_add_(0, key, torch.ones_like(key))
    _count_load(counts[:N])
    offs = torch.cumsum(counts[:N], 0).to(torch.int32)
    M = T * min(k, N)
    rows = torch.argsort(key, stable=True)[:M]  # held pairs first, by expert
    xs = xt[rows // k]  # (M, D)
    up = torch._grouped_mm(xs, w_up, offs=offs)
    if cfg.mlp_kind in ("swiglu", "geglu"):
        act = F.silu if cfg.mlp_kind == "swiglu" else layers.gelu
        h = act(torch._grouped_mm(xs, w_gate, offs=offs)) * up
    else:
        h = layers.gelu(up)
    ys = torch._grouped_mm(h, w_down, offs=offs)  # (M, D)
    # rows past the last offset are no group's: the product leaves them
    # unwritten
    live = torch.arange(M, device=xt.device) < offs[-1]
    ys = torch.where(live[:, None], ys, 0)
    pairs = torch.zeros((T * k, xt.shape[1]), dtype=ys.dtype,
                        device=xt.device).index_copy_(0, rows, ys)
    wk = torch.where(held, w, 0.0) * cfg.routed_scaling  # (T, k) float32
    return torch.sum(pairs.view(T, k, -1).float() * wk[..., None], 1)


# tokens a dropless dispatch sorts at once: the sort's buffers grow with
# the tokens (a 128 x 1,024 prefill at d 2,048 would hold ~9 GB of them);
# routing is per token, so the chunks change no result
DISPATCH_CHUNK = 16384


def dropless_forward(p, x: torch.Tensor,
                     cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """x: (B, S, E) -> (the held experts' part plus the shared experts',
    (B, S, E); no aux), tokens dispatched ``DISPATCH_CHUNK`` at a time.
    On the card the layer lies between the ``moe_begin`` and ``moe_end``
    phase markers."""
    markers.mark("moe_begin", x.device)
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    dt = x.dtype
    gated = cfg.mlp_kind in ("swiglu", "geglu")
    weights = (p["router"], p["w_gate"].to(dt) if gated else None,
               p["w_up"].to(dt), p["w_down"].to(dt))
    c = DISPATCH_CHUNK
    y = torch.cat([_routed(xt[s:s + c], *weights, cfg)
                   for s in range(0, B * S, c)]).to(dt).reshape(B, S, D)
    if "shared" in p:
        y = y + layers.apply_mlp(p["shared"], x, cfg.mlp_kind)
    markers.mark("moe_end", x.device)
    return y, {}
