"""DeepSeek-V2 (hf:deepseek-ai/DeepSeek-V2-Lite, ``modeling_deepseek.py``)
in plain PyTorch, float32, on one card's share of its experts.

Pre-norm blocks with RMSNorm; multi-head latent attention without a q
LoRA: the queries from one projection ``wq`` (per head ``qk_nope`` dims
and ``qk_rope`` rotary dims), keys and values from a latent of
``kv_lora_rank`` dims (RMSNorm'd, ``kv_a_layernorm``) expanded per head by
``kv_b``, and one rotary key of ``qk_rope`` dims shared by every head;
YaRN rotary frequencies and the softmax scale ``(qk_nope + qk_rope)^-0.5
* m^2``, ``m = 0.1 * mscale_all_dim * ln(factor) + 1``; a causal softmax;
``first_k_dense_replace`` dense SwiGLU blocks of ``intermediate_size``,
then expert blocks: a router over all ``published_n_routed_experts``
(float32 scores, softmax, the greedy top ``num_experts_per_tok``, their
probabilities not renormalised, times ``routed_scaling_factor``), the
``n_routed_experts`` held here (experts ``expert_share *
n_routed_experts`` on) each run by a plain loop over the tokens routed
to it, and ``n_shared_experts`` shared experts as one SwiGLU of width
``n_shared_experts * moe_intermediate_size`` on every token; a final
RMSNorm and an untied LM head.

Departures from HF, each on both sides alike:

- the rotary dims are rotated as two halves of the columns as the
  projections give them (the first half against the second); HF first
  de-interleaves them (``view(d/2, 2).transpose``), so HF's layout is this
  one with the rope columns of ``wq`` and ``kv_a`` permuted, which random
  weights do not tell apart;
- the experts held elsewhere add nothing (the card's share of an EP
  deployment: what their cards would add is left out, and that partial
  result goes on to the next layer);
- weights are random from the seed (``init_params``), in the layout the
  benchmark hands the program: the leaves of the one dense block stacked
  under ``dense/b0``, those of the expert blocks under ``main/b0``.

With ``quant`` every product's two operands are rounded first (the
control's lower precision).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.refs.lm_ref import fp8  # noqa: F401  (the control's rounding)

Tree = Dict


# ---------------------------------------------------------------- weights
def held_experts(c: Dict) -> Tuple[int, int]:
    """(first, count) of the experts held here among the router's."""
    n = c["n_routed_experts"]
    return c["expert_share"] * n, n


def leaf_specs(c: Dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """(name, shape, draw, scale) of every leaf, in the order they are
    drawn: ``normal`` times scale, ``uniform`` in [-scale, scale), or
    ``full`` of scale."""
    E, H, V = c["hidden_size"], c["num_attention_heads"], c["vocab_size"]
    r, dn = c["kv_lora_rank"], c["qk_nope_head_dim"]
    dr, dv = c["qk_rope_head_dim"], c["v_head_dim"]
    Ld = c["first_k_dense_replace"]
    Lm = c["num_hidden_layers"] - Ld
    Fd, Fe = c["intermediate_size"], c["moe_intermediate_size"]
    N, R = c["n_routed_experts"], c["published_n_routed_experts"]
    Fs = c["n_shared_experts"] * Fe
    u = 1.0 / math.sqrt(E)

    def block(g, L):
        return [
            (f"{g}/b0/norm1/scale", (L, E), "full", 1.0),
            (f"{g}/b0/mixer/wq", (L, E, H, dn + dr), "uniform", u),
            (f"{g}/b0/mixer/kv_a", (L, E, r + dr), "uniform", u),
            (f"{g}/b0/mixer/kv_norm", (L, r), "full", 1.0),
            (f"{g}/b0/mixer/kv_b", (L, r, H, dn + dv), "uniform",
             1.0 / math.sqrt(r)),
            (f"{g}/b0/mixer/wo", (L, H, dv, E), "uniform",
             1.0 / math.sqrt(H * dv)),
            (f"{g}/b0/norm2/scale", (L, E), "full", 1.0),
        ]

    dense = [
        ("dense/b0/ffn/w_gate", (Ld, E, Fd), "uniform", u),
        ("dense/b0/ffn/w_up", (Ld, E, Fd), "uniform", u),
        ("dense/b0/ffn/w_down", (Ld, Fd, E), "uniform", 1.0 / math.sqrt(Fd)),
    ]
    experts = [
        ("main/b0/ffn/router", (Lm, E, R), "uniform", u),
        ("main/b0/ffn/w_gate", (Lm, N, E, Fe), "uniform", u),
        ("main/b0/ffn/w_up", (Lm, N, E, Fe), "uniform", u),
        ("main/b0/ffn/w_down", (Lm, N, Fe, E), "uniform",
         1.0 / math.sqrt(Fe)),
        ("main/b0/ffn/shared/w_gate", (Lm, E, Fs), "uniform", u),
        ("main/b0/ffn/shared/w_up", (Lm, E, Fs), "uniform", u),
        ("main/b0/ffn/shared/w_down", (Lm, Fs, E), "uniform",
         1.0 / math.sqrt(Fs)),
    ]
    return ([("embed/table", (V, E), "normal", 0.02)]
            + block("dense", Ld) + dense + block("main", Lm) + experts
            + [("final_norm/scale", (E,), "full", 1.0),
               ("lm_head", (E, V), "uniform", u)])


def init_params(c: Dict, gen: torch.Generator, device) -> Tree:
    """The benchmark's float32 weights from ``gen`` (on ``device``), one
    draw a leaf, as a nested dict."""
    tree: Tree = {}
    for name, shape, draw, scale in leaf_specs(c):
        if draw == "normal":
            t = torch.randn(shape, generator=gen, device=device) * scale
        elif draw == "uniform":
            t = (torch.rand(shape, generator=gen, device=device) * 2 - 1) * scale
        else:
            t = torch.full(shape, scale, device=device)
        node = tree
        *path, last = name.split("/")
        for k in path:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


# ---------------------------------------------------------------- rotary
def yarn_mscale(factor: float, mscale: float) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(c: Dict, device) -> torch.Tensor:
    """HF's ``DeepseekV2YarnRotaryEmbedding`` inverse frequencies."""
    y, dim, base = c["rope_scaling"], c["qk_rope_head_dim"], c["rope_theta"]

    def corr(turns):
        return (dim * math.log(y["original_max_position_embeddings"]
                               / (turns * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(corr(y["beta_fast"])), 0)
    high = min(math.ceil(corr(y["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ar = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / (base ** ar)
    inter = 1.0 / (y["factor"] * base ** ar)
    ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device) - low)
            / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def softmax_scale(c: Dict) -> float:
    s = (c["qk_nope_head_dim"] + c["qk_rope_head_dim"]) ** -0.5
    y = c.get("rope_scaling")
    if y and y.get("mscale_all_dim"):
        m = yarn_mscale(y["factor"], y["mscale_all_dim"])
        s = s * m * m
    return s


def _rope(x, pos, inv, mscale):
    """x (B, L, H, d): the two halves rotated at positions ``pos`` (L,)."""
    ang = pos[:, None].float() * inv  # (L, d/2)
    cos = (torch.cos(ang) * mscale)[None, :, None, :]
    sin = (torch.sin(ang) * mscale)[None, :, None, :]
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h], x[..., h:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _rms(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


# ---------------------------------------------------------------- forward
class DeepSeekV2:
    def __init__(self, params: Tree, c: Dict,
                 quant: Optional[Callable] = None):
        self.p, self.c = params, c
        self.q = quant or (lambda x: x)
        self.first, self.n_held = held_experts(c)
        y = c["rope_scaling"]
        self.mscale = (yarn_mscale(y["factor"], y["mscale"])
                       / yarn_mscale(y["factor"], y["mscale_all_dim"]))
        self.scale = softmax_scale(c)
        self._inv = None

    def _mm(self, a, b):
        return self.q(a) @ self.q(b)

    def _attention(self, h, m, l, pos):
        c = self.c
        B, L, E = h.shape
        H, r = c["num_attention_heads"], c["kv_lora_rank"]
        dn, dr, dv = (c["qk_nope_head_dim"], c["qk_rope_head_dim"],
                      c["v_head_dim"])
        q = self._mm(h, m["wq"][l].reshape(E, -1)).view(B, L, H, dn + dr)
        q_nope, q_pe = q[..., :dn], q[..., dn:]
        ckv = self._mm(h, m["kv_a"][l])
        latent = _rms(ckv[..., :r], m["kv_norm"][l], c["rms_norm_eps"])
        k_pe = ckv[..., r:][:, :, None, :]  # (B, L, 1, dr)
        kv = self._mm(latent, m["kv_b"][l].reshape(r, -1)).view(
            B, L, H, dn + dv)
        k_nope, v = kv[..., :dn], kv[..., dn:]
        q_pe = _rope(q_pe, pos, self._inv, self.mscale)
        k_pe = _rope(k_pe, pos, self._inv, self.mscale)
        qh = torch.cat([q_nope, q_pe], -1).transpose(1, 2)  # (B, H, L, d)
        kh = torch.cat([k_nope, k_pe.expand(B, L, H, dr)], -1).transpose(1, 2)
        s = self._mm(qh, kh.transpose(-1, -2)) * self.scale
        causal = torch.ones(L, L, dtype=torch.bool, device=h.device).tril()
        w = torch.softmax(s.masked_fill(~causal, float("-inf")), -1)
        o = self._mm(w, v.transpose(1, 2)).transpose(1, 2).reshape(B, L, H * dv)
        return self._mm(o, m["wo"][l].reshape(H * dv, E))

    def _mlp(self, x, w_gate, w_up, w_down):
        return self._mm(F.silu(self._mm(x, w_gate)) * self._mm(x, w_up),
                        w_down)

    def route(self, x, f, l):
        """(weights (T, k), global expert ids (T, k)) of tokens x (T, E)."""
        c = self.c
        probs = torch.softmax(self._mm(x, f["router"][l]), -1)
        w, idx = torch.topk(probs, c["num_experts_per_tok"], -1)
        return w * c["routed_scaling_factor"], idx

    def routed(self, x, f, l, w, idx):
        """The held experts' part of tokens x (T, E): each held expert over
        the tokens routed to it, by a plain loop."""
        out = torch.zeros_like(x)
        for e in range(self.n_held):
            hit = idx == self.first + e  # (T, k)
            tok = hit.any(-1).nonzero()[:, 0]
            if tok.numel() == 0:
                continue
            we = (w * hit)[tok].sum(-1, keepdim=True)
            y = self._mlp(x[tok], f["w_gate"][l, e], f["w_up"][l, e],
                          f["w_down"][l, e])
            out.index_add_(0, tok, we * y)
        return out

    def _moe(self, h, f, l):
        B, L, E = h.shape
        x = h.reshape(B * L, E)
        w, idx = self.route(x, f, l)
        s = f["shared"]
        y = self.routed(x, f, l, w, idx) + self._mlp(
            x, s["w_gate"][l], s["w_up"][l], s["w_down"][l])
        return y.view(B, L, E)

    def _layer(self, x, group, l, pos):
        b, eps = self.p[group]["b0"], self.c["rms_norm_eps"]
        x = x + self._attention(_rms(x, b["norm1"]["scale"][l], eps),
                                b["mixer"], l, pos)
        h = _rms(x, b["norm2"]["scale"][l], eps)
        f = b["ffn"]
        if group == "dense":
            return x + self._mlp(h, f["w_gate"][l], f["w_up"][l],
                                 f["w_down"][l])
        return x + self._moe(h, f, l)

    def hidden(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, L) ids -> the final norm's output (B, L, E)."""
        c = self.c
        L = tokens.shape[1]
        pos = torch.arange(L, device=tokens.device)
        self._inv = yarn_inv_freq(c, tokens.device)
        x = self.p["embed"]["table"][tokens.long()]
        Ld = c["first_k_dense_replace"]
        for i in range(c["num_hidden_layers"]):
            x = (self._layer(x, "dense", i, pos) if i < Ld
                 else self._layer(x, "main", i - Ld, pos))
        return _rms(x, self.p["final_norm"]["scale"], c["rms_norm_eps"])

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return self._mm(h, self.p["lm_head"])
