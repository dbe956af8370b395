"""Attention: GQA/MHA/MQA with full, sliding-window and chunked (online-
softmax) implementations, plus MLA (multi-head latent attention,
MiniCPM3/DeepSeek-style), with KV caches for serving.

Cache formats
  full cache : k/v (B, S_max, Kv, D) — dense archs; entries written at
               their absolute position.
  ring cache : k/v (B, W, Kv, D) for SWA/local-attention archs — slot =
               pos % W, so a long decode holds only W entries.
  mla cache  : c_kv (B, S, r) + k_rope (B, S, dr) — compressed latents.

Keys are stored rope-applied (absolute positions).  All softmax math in
float32, and scores are accumulated in float32 whatever the compute
dtype.  The einsums, masks and softmax mirror the reference's; the decode
functions write the new entries into the cache they are given, in place,
and return it.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from repro_torch.distributed.partitioning import (constrain, is_dtensor,
                                                  local_rows, merge_dims, pad,
                                                  project, run_local,
                                                  unflatten)
from repro_torch.kernels import decode_attention, markers
from repro_torch.kernels import mla_decode as mla_kernel
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init

NEG_INF = -1e30


# ================================================================ params
def gqa_init(init: Init, cfg: ModelConfig):
    H, Kv, D, E = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    p = {
        "wq": layers.dense_init(init, (E, H, D),
                                ("embed", "heads", "head_dim")),
        "wk": layers.dense_init(init, (E, Kv, D), ("embed", "kv", "head_dim")),
        "wv": layers.dense_init(init, (E, Kv, D), ("embed", "kv", "head_dim")),
        "wo": layers.dense_init(init, (H, D, E),
                                ("heads", "head_dim", "embed"), fan_in_dims=2),
    }
    if cfg.qkv_bias:
        p["bq"] = init.full((H, D), 0.0, axes=("heads", "head_dim"))
        p["bk"] = init.full((Kv, D), 0.0, axes=("kv", "head_dim"))
        p["bv"] = init.full((Kv, D), 0.0, axes=("kv", "head_dim"))
    return p


def mla_init(init: Init, cfg: ModelConfig):
    """MLA's params; without a q LoRA (``q_lora_rank`` None, DeepSeek-V2-
    Lite) the queries come from one projection ``wq``."""
    E, H = cfg.d_model, cfg.num_heads
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    if r_q is None:
        q = {"wq": layers.dense_init(init, (E, H, dn + dr),
                                     ("embed", "heads", "head_dim"))}
    else:
        q = {
            "q_a": layers.dense_init(init, (E, r_q), ("embed", "q_rank")),
            "q_norm": init.full((r_q,), 1.0, axes=("q_rank",)),
            "q_b": layers.dense_init(init, (r_q, H, dn + dr),
                                     ("q_rank", "heads", "head_dim")),
        }
    return {
        **q,
        "kv_a": layers.dense_init(init, (E, r_kv + dr), ("embed", "kv_rank")),
        "kv_norm": init.full((r_kv,), 1.0, axes=("kv_rank",)),
        "kv_b": layers.dense_init(init, (r_kv, H, dn + dv),
                                  ("kv_rank", "heads", "head_dim")),
        "wo": layers.dense_init(init, (H, dv, E),
                                ("heads", "head_dim", "embed"), fan_in_dims=2),
    }


# ================================================================ masking
def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor,
          window: Optional[int]) -> torch.Tensor:
    """(..., Lq, Lk) boolean validity: causal + optional sliding window +
    kv_pos >= 0 (ring-buffer slots not yet written have kv_pos < 0)."""
    kv = kv_pos[..., None, :]
    q = q_pos[..., :, None]
    m = (kv <= q) & (kv >= 0)
    if window is not None:
        m = m & (kv > q - window)
    return m


def _rms(x, scale, eps=1e-6):
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf ** 2, -1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


# ------------------------------------------------- int8 KV cache (paper's
# Q-format applied to attention state: per-(token, head) max-abs scales)
def kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S, Kv, D) -> (int8 codes, (B, S, Kv) scales)."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = amax / 127.0 + 1e-12
    codes = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return codes.to(torch.int8), scale.to(x.dtype)


def kv_dequantize(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes.to(scale.dtype) * scale[..., None]


# ================================================================ attend
def attend_full(
    q: torch.Tensor,  # (B, Lq, Kv, G, D)  (G = H // Kv query groups)
    k: torch.Tensor,  # (B, Lk, Kv, D)
    v: torch.Tensor,  # (B, Lk, Kv, D)
    q_pos: torch.Tensor,  # (B, Lq)
    kv_pos: torch.Tensor,  # (B, Lk)
    *,
    window: Optional[int],
    scale: float,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    scores = torch.einsum("blkgd,bskd->bkgls", q.float(), k.float()) * scale
    if softcap is not None:
        scores = softcap * torch.tanh(scores / softcap)
    mask = _mask(q_pos, kv_pos, window)[:, None, None]  # (B,1,1,Lq,Lk)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgls,bskd->blkgd", w, v)


def attend_chunked(
    q: torch.Tensor,  # (B, Lq, Kv, G, D)
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    kv_pos: torch.Tensor,
    *,
    window: Optional[int],
    scale: float,
    chunk: int,
    softcap: Optional[float] = None,
    unroll: bool = False,
) -> torch.Tensor:
    """Online-softmax streaming over KV chunks — O(Lq*chunk) live scores.

    Equal to ``attend_full`` within float32 rounding; used for long
    prefill.  The reference scans the chunks (or unrolls them with
    ``unroll=True``); here both are one Python loop, so ``unroll`` is
    accepted and changes nothing.
    """
    del unroll
    B, Lk = k.shape[0], k.shape[1]
    pad = (-Lk) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=-1)
    n_chunks = (Lk + pad) // chunk
    _, Lq, Kv, G, _ = q.shape
    qf = q.float()
    m = torch.full((B, Kv, G, Lq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l_sum = torch.zeros((B, Kv, G, Lq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Lq, Kv, G, v.shape[-1]), dtype=torch.float32,
                      device=q.device)
    for i in range(n_chunks):
        sl = slice(i * chunk, (i + 1) * chunk)
        k_i, v_i, p_i = k[:, sl], v[:, sl], kv_pos[:, sl]
        s = torch.einsum("blkgd,bskd->bkgls", qf, k_i.float()) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        msk = _mask(q_pos, p_i, window)[:, None, None]
        s = torch.where(msk, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        # guard fully-masked rows (m_new == NEG_INF)
        m_safe = torch.clamp(m_new, min=-0.9e30)
        corr = torch.exp(m - m_safe)
        p = torch.exp(s - m_safe[..., None])
        l_sum = l_sum * corr + torch.sum(p, dim=-1)
        pv = torch.einsum("bkgls,bskd->blkgd", p.to(v_i.dtype), v_i)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
        m = m_new
    l_sum = torch.clamp(l_sum, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return (acc / l_sum).to(v.dtype)


def _local_attend(attend, q, k, v, q_pos, kv_pos, **kw):
    """``attend(q, k, v, q_pos, kv_pos, **kw)`` for q (B, Lq, Kv, G, D)
    and k, v (B, Lk, Kv, D); over DTensors each device attends its batch
    and kv-head block (``partitioning.run_local``)."""
    return run_local(
        functools.partial(attend, **kw), (q, k, v, q_pos, kv_pos),
        (("batch", None, "kv", None, None), ("batch", None, "kv", None),
         ("batch", None, "kv", None), ("batch", None), ("batch", None)),
        (*q.shape[:-1], v.shape[-1]), ("batch", None, "kv", None, None))


def _attend(q, k, v, q_pos, kv_pos, cfg: ModelConfig, scale: float):
    window = cfg.window if cfg.attention_kind in ("swa", "local") else None
    impl = cfg.attn_impl
    if impl == "auto":
        impl = "chunked" if k.shape[1] >= 8192 else "full"
    kw = dict(window=window, scale=scale, softcap=cfg.attn_logit_softcap)
    if impl == "chunked":
        return _local_attend(attend_chunked, q, k, v, q_pos, kv_pos,
                             chunk=cfg.attn_chunk,
                             unroll=cfg.attn_chunk_unroll, **kw)
    return _local_attend(attend_full, q, k, v, q_pos, kv_pos, **kw)


def _is_ring(cfg: ModelConfig) -> bool:
    return bool(cfg.attention_kind in ("swa", "local") and cfg.window)


def _pad_seq(t: torch.Tensor, cache_len: int) -> torch.Tensor:
    """``t`` (B, L, ...) as a cache of ``cache_len`` rows: its rows first,
    zeros after."""
    if t.shape[1] > cache_len:
        raise ValueError(f"{t.shape[1]} rows do not fit a cache of "
                         f"{cache_len}")
    return pad(t, (0, 0) * (t.ndim - 2) + (0, cache_len - t.shape[1]))


def _place_ring(t: torch.Tensor, slots: torch.Tensor, W: int,
                axes) -> torch.Tensor:
    """The last ``slots.shape[1]`` rows of ``t`` (B, L, ...) placed at
    their ring ``slots`` (B, take) of a zeroed ring of ``W`` rows; a
    DTensor is placed shard by shard."""
    take = slots.shape[1]

    def place(x, s):
        c = torch.zeros((x.shape[0], W, *x.shape[2:]), dtype=x.dtype,
                        device=x.device)
        bidx = torch.arange(x.shape[0], device=x.device)[:, None]
        return torch.index_put(c, (bidx, s), x[:, -take:])

    return run_local(place, (t, slots), (axes, ("batch", None)),
                     (t.shape[0], W, *t.shape[2:]), axes)


def _write_rows(cache: torch.Tensor, bidx: torch.Tensor, slot: torch.Tensor,
                new: torch.Tensor) -> None:
    """``cache[b, slot[b]] = new[b]`` in place; a slot past the cache's end
    drops its write, as the reference's out-of-bounds scatter does.  A
    DTensor cache is written shard by shard (``partitioning.local_rows``)."""
    if is_dtensor(cache):
        # each device writes the rows its shard of the cache holds
        return _write_rows(*local_rows(cache, bidx, slot, new))
    S = cache.shape[1]
    at = torch.clamp(slot, max=S - 1)
    keep = (slot < S).reshape(*slot.shape, *([1] * (new.ndim - 2)))
    cache[bidx, at] = torch.where(keep, new, cache[bidx, at])


# ================================================================ GQA fwd
def _project_qkv(p, x, cfg: ModelConfig, positions):
    H, Kv = cfg.num_heads, cfg.num_kv_heads
    q = project(x, p["wq"].to(x.dtype),
                ("batch", "act_seq", "heads", "head_dim"))
    k = project(x, p["wk"].to(x.dtype),
                ("batch", "act_seq", "kv", "head_dim"))
    v = project(x, p["wv"].to(x.dtype),
                ("batch", "act_seq", "kv", "head_dim"))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    q = constrain(q, ("batch", "act_seq", "heads", "head_dim"))
    k = constrain(k, ("batch", "act_seq", "kv", "head_dim"))
    v = constrain(v, ("batch", "act_seq", "kv", "head_dim"))
    q = layers.apply_rope(q, positions, cfg.rope_theta, cfg.rope_pct)
    k = layers.apply_rope(k, positions, cfg.rope_theta, cfg.rope_pct)
    return unflatten(q, 2, (Kv, H // Kv)), k, v


def _heads_out(o, wo):
    """``einsum("blhd,hde->ble")`` as a matmul over (h, d) merged, shard
    by shard over DTensors (``partitioning.merge_dims``)."""
    return merge_dims(o, 2, 3) @ merge_dims(wo, 0, 1)


def _out_proj(p, o, x, cfg: ModelConfig):
    o = o.reshape(*x.shape[:2], cfg.num_heads, cfg.head_dim)
    o = constrain(o, ("batch", "act_seq", "heads", "head_dim"))
    return _heads_out(o, p["wo"].to(x.dtype))


def gqa_forward(p, x: torch.Tensor, positions: torch.Tensor,
                cfg: ModelConfig) -> torch.Tensor:
    """Training / prefill self-attention (causal, optional SWA)."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = _attend(q, k, v, positions, positions, cfg, cfg.head_dim ** -0.5)
    return _out_proj(p, o, x, cfg)


def gqa_prefill(p, x, positions, cfg: ModelConfig, cache_len: int):
    """Like gqa_forward but also returns the populated KV cache."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = _attend(q, k, v, positions, positions, cfg, cfg.head_dim ** -0.5)
    out = _out_proj(p, o, x, cfg)

    L = x.shape[1]
    parts = {"k": k, "v": v}
    if cfg.kv_cache_quant:
        kq, ks = kv_quantize(k)
        vq, vs = kv_quantize(v)
        parts = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    axes = {"k": ("batch", None, "kv", "head_dim"),
            "k_scale": ("batch", None, "kv")}
    axes["v"], axes["v_scale"] = axes["k"], axes["k_scale"]
    if _is_ring(cfg):
        W = min(cfg.window, cache_len)
        # keep the last W entries, placed at slot = pos % W
        slots = positions[:, -min(L, W):] % W
        return out, {name: _place_ring(t, slots, W, axes[name])
                     for name, t in parts.items()}
    return out, {name: _pad_seq(t, cache_len) for name, t in parts.items()}


def gqa_decode(
    p,
    x: torch.Tensor,  # (B, 1, E)
    pos: torch.Tensor,  # (B,) current absolute position
    cache: Dict[str, torch.Tensor],
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step against a full or ring KV cache (updated in place).
    Where the input allows it (``decode_attention.routes``: a full bf16
    cache on the card, among others) the attention runs the hand-written
    kernel ``kernels/decode_attention.py``, else ``attend_full``."""
    positions = pos[:, None]
    q, k, v = _project_qkv(p, x, cfg, positions)
    ring = _is_ring(cfg)
    S = cache["k"].shape[1]
    bidx = torch.arange(x.shape[0], device=x.device)[:, None]
    slot = (pos % S)[:, None] if ring else pos[:, None]
    if "k_scale" in cache:
        kq, ks = kv_quantize(k)
        vq, vs = kv_quantize(v)
        for name, t in (("k", kq), ("v", vq), ("k_scale", ks),
                        ("v_scale", vs)):
            _write_rows(cache[name], bidx, slot, t)
        ck = kv_dequantize(cache["k"], cache["k_scale"])
        cv = kv_dequantize(cache["v"], cache["v_scale"])
    else:
        _write_rows(cache["k"], bidx, slot, k)
        _write_rows(cache["v"], bidx, slot, v)
        ck, cv = cache["k"], cache["v"]

    scale = cfg.head_dim ** -0.5
    if decode_attention.routes(q, ck, cv, ring=ring,
                               quantized="k_scale" in cache,
                               softcap=cfg.attn_logit_softcap):
        # the hand-written kernel reads the valid bf16 cache rows once
        o = decode_attention.decode_attention(q, ck, cv, pos, scale)
        return _out_proj(p, o, x, cfg), cache

    j = torch.arange(S, device=x.device)[None, :]
    if ring:
        # reconstruct absolute positions of ring slots
        kv_pos = pos[:, None] - torch.remainder(slot - j, S)
    else:
        kv_pos = torch.where(j <= pos[:, None], j, -1)
    kv_pos = torch.where(kv_pos >= 0, kv_pos, -1)

    o = _local_attend(
        attend_full, q, ck, cv, positions, kv_pos,
        window=cfg.window if ring else None, scale=scale,
        softcap=cfg.attn_logit_softcap,
    )
    return _out_proj(p, o, x, cfg), cache


# ================================================================ MLA fwd
def _mla_rope(t, positions, cfg: ModelConfig):
    """Rotary embedding of MLA's rope dims, YaRN-scaled where the config
    says (``yarn_factor``)."""
    if not cfg.yarn_factor:
        return layers.apply_rope(t, positions, cfg.rope_theta)
    inv = layers.yarn_inv_freq(
        t.shape[-1], cfg.rope_theta, cfg.yarn_factor,
        cfg.yarn_original_max_pos, cfg.yarn_beta_fast, cfg.yarn_beta_slow,
        device=t.device)
    cos_scale = (layers.yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale)
                 / layers.yarn_mscale(cfg.yarn_factor,
                                      cfg.yarn_mscale_all_dim))
    return layers.apply_rope(t, positions, cfg.rope_theta, inv_freq=inv,
                             cos_scale=cos_scale)


def mla_scale(cfg: ModelConfig) -> float:
    """MLA's softmax scale: ``(qk_nope + qk_rope) ** -0.5``, times YaRN's
    temperature squared where ``yarn_mscale_all_dim`` is set."""
    scale = (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5
    if cfg.yarn_factor and cfg.yarn_mscale_all_dim:
        m = layers.yarn_mscale(cfg.yarn_factor, cfg.yarn_mscale_all_dim)
        scale = scale * m * m
    return scale


def _mla_qkv(p, x, cfg: ModelConfig, positions):
    dn = cfg.qk_nope_head_dim
    heads = ("batch", "act_seq", "heads", "head_dim")
    if "wq" in p:
        q = project(x, p["wq"].to(x.dtype), heads)
    else:
        cq = _rms(x @ p["q_a"].to(x.dtype), p["q_norm"])
        q = project(cq, p["q_b"].to(x.dtype), heads)
    q = constrain(q, heads)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = _mla_rope(q_rope, positions, cfg)
    ckv_full = x @ p["kv_a"].to(x.dtype)
    c_kv = _rms(ckv_full[..., : cfg.kv_lora_rank], p["kv_norm"])
    k_rope = ckv_full[..., cfg.kv_lora_rank:][:, :, None, :]  # (B,L,1,dr)
    k_rope = _mla_rope(k_rope, positions, cfg)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def _mla_expand_kv(p, c_kv, cfg: ModelConfig):
    dn = cfg.qk_nope_head_dim
    kv = project(c_kv, p["kv_b"].to(c_kv.dtype),
                 ("batch", "act_seq", "heads", "head_dim"))
    kv = constrain(kv, ("batch", "act_seq", "heads", "head_dim"))
    return kv[..., :dn], kv[..., dn:]  # k_nope (B,S,H,dn), v (B,S,H,dv)


def _mla_attend(p, q_nope, q_rope, c_kv, k_rope, q_pos, kv_pos, cfg,
                absorb, pos=None):
    """Shared MLA attention core; absorb=True uses the latent-space trick
    (score/context computed against c_kv directly — decode optimization).
    ``pos`` (B,): a decode step over the full cache that
    ``mla_kernel.routes`` sent to the kernel (``_mla_absorbed``)."""
    dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
    scale = mla_scale(cfg)
    if absorb:
        kv_b_k = p["kv_b"][..., :dn]  # (r, H, dn)
        kv_b_v = p["kv_b"][..., dn:]  # (r, H, dv)
        heads = ("batch", None, "heads", None)
        o = run_local(
            functools.partial(_mla_absorbed, scale=scale, pos=pos),
            (q_nope, q_rope, c_kv, k_rope, kv_b_k, kv_b_v, q_pos, kv_pos),
            (heads, heads, ("batch", None, None), ("batch", None, None),
             (None, "heads", None), (None, "heads", None), ("batch", None),
             ("batch", None)),
            (*q_nope.shape[:-1], kv_b_v.shape[-1]), heads)
    else:
        k_nope, v = _mla_expand_kv(p, c_kv, cfg)
        B, S = k_rope.shape[0], k_rope.shape[1]
        k_rope_h = k_rope[:, :, None, :].expand(B, S, cfg.num_heads, dr)
        k = torch.cat([k_nope, k_rope_h], dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        # MLA has no KV grouping: Kv = H, G = 1
        o = _local_attend(
            attend_full, q[:, :, :, None, :], k, v, q_pos, kv_pos,
            window=None, scale=scale,
        )[:, :, :, 0, :]
    return _heads_out(o, p["wo"].to(o.dtype))


def _mla_absorbed(q_nope, q_rope, c_kv, k_rope, kv_b_k, kv_b_v, q_pos,
                  kv_pos, scale: float, pos=None):
    """MLA attention against the latent cache itself (the absorbed
    decode form): score and context computed against c_kv directly, by
    the hand-written kernel ``kernels/mla_decode.py`` where ``pos`` (B,)
    is given (rows ``j <= pos[b]`` valid), else by ``_mla_latent``."""
    q_eff = torch.einsum("blhd,rhd->blhr", q_nope, kv_b_k.to(q_nope.dtype))
    if pos is None:
        ctx = _mla_latent(q_eff, q_rope, c_kv, k_rope, q_pos, kv_pos, scale)
    else:
        # reads the valid bf16 cache rows in place, once
        ctx = mla_kernel.mla_decode(q_eff, q_rope, c_kv, k_rope, pos, scale)
    return torch.einsum("blhr,rhd->blhd", ctx, kv_b_v.to(ctx.dtype))


def _mla_latent(q_eff, q_rope, c_kv, k_rope, q_pos, kv_pos, scale: float):
    """The latent context (B, Lq, H, r) of the absorbed query ``q_eff``
    against the cache: float32 scores, softmax, bf16 weights; the plain
    version of ``kernels/mla_decode.py``."""
    s = torch.einsum("blhr,bsr->bhls", q_eff.float(), c_kv.float())
    s = s + torch.einsum("blhd,bsd->bhls", q_rope.float(), k_rope.float())
    s = s * scale
    mask = _mask(q_pos, kv_pos, None)[:, None]
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(c_kv.dtype)
    return torch.einsum("bhls,bsr->blhr", w, c_kv)


def mla_forward(p, x, positions, cfg: ModelConfig, absorb: bool = False):
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, positions)
    return _mla_attend(
        p, q_nope, q_rope, c_kv, k_rope, positions, positions, cfg, absorb
    )


def mla_prefill(p, x, positions, cfg: ModelConfig, cache_len: int,
                absorb: bool = False):
    """Like mla_forward but also returns the latent cache.  On the card the
    core, attention through the cache's rows to ``wo``, lies between the
    ``mla_begin`` and ``mla_end`` phase markers."""
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, positions)
    markers.mark("mla_begin", x.device)
    out = _mla_attend(
        p, q_nope, q_rope, c_kv, k_rope, positions, positions, cfg, absorb
    )
    cache = {"c_kv": _pad_seq(c_kv, cache_len),
             "k_rope": _pad_seq(k_rope, cache_len)}
    markers.mark("mla_end", x.device)
    return out, cache


def mla_decode(p, x, pos, cache, cfg: ModelConfig, absorb: bool = True):
    """One decode step against the latent cache (updated in place).  On the
    card the core, from the cache write to ``wo``, lies between the
    ``mla_begin`` and ``mla_end`` phase markers.  Where the input allows it
    (``mla_kernel.routes``: the absorbed form over a bf16 cache on the
    card, rank 512 and rope 64, among others) the latent context comes from
    the hand-written kernel ``kernels/mla_decode.py``, else from
    ``_mla_latent``."""
    positions = pos[:, None]
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(p, x, cfg, positions)
    markers.mark("mla_begin", x.device)
    bidx = torch.arange(x.shape[0], device=x.device)[:, None]
    _write_rows(cache["c_kv"], bidx, positions, c_kv_new)
    _write_rows(cache["k_rope"], bidx, positions, k_rope_new)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]
    S = c_kv.shape[1]
    j = torch.arange(S, device=x.device)[None, :]
    kv_pos = torch.where(j <= pos[:, None], j, -1)
    routed = absorb and mla_kernel.routes(q_nope, q_rope, c_kv, k_rope)
    out = _mla_attend(
        p, q_nope, q_rope, c_kv, k_rope, positions, kv_pos, cfg, absorb,
        pos=pos if routed else None,
    )
    markers.mark("mla_end", x.device)
    return out, cache
