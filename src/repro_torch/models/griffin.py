"""RG-LRU recurrent block (Griffin / RecurrentGemma, De et al. 2024).

Recurrence (per channel):
    r_t = sigmoid(W_a x_t + b_a)                (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                (input gate)
    log a_t = -c * softplus(Lambda) * r_t       (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The recurrence is linear in h given the gates, so prefill runs it as a
log-depth scan over L (Hillis-Steele doubling: ceil(log2 L) vectorised
steps); decode is the O(1) step.

The full recurrent *block* (as in RecurrentGemma): two input branches
(linear y-gate with GELU, linear x into conv1d(4) into RG-LRU),
elementwise merge, linear out.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.partitioning import constrain, pad, run_local
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init

CONV_WIDTH = 4  # temporal conv width (recurrentgemma)


def rglru_block_init(init: Init, cfg: ModelConfig):
    E = cfg.d_model
    R = cfg.lru_width or E
    # Lambda init so that a^c in [0.9, 0.999] at r=1 (paper init)
    u = init.uniform((R,), 0.9, 0.999, axes=("lru",))
    lam = init.map(u, lambda u: torch.log(
        torch.expm1(-torch.log(u.float()) / cfg.rglru_c)).to(init.dtype))
    return {
        "w_y": layers.dense_init(init, (E, R), ("embed", "lru")),
        "w_in": layers.dense_init(init, (E, R), ("embed", "lru")),
        "conv_w": init.normal((CONV_WIDTH, R), 0.1, axes=("conv_w", "lru")),
        "w_a": layers.dense_init(init, (R, R), ("lru", "lru_in")),
        "b_a": init.full((R,), 0.0, axes=("lru",)),
        "w_gx": layers.dense_init(init, (R, R), ("lru", "lru_in")),
        "b_gx": init.full((R,), 0.0, axes=("lru",)),
        "lambda_raw": lam,
        "w_out": layers.dense_init(init, (R, E), ("lru", "embed")),
    }


def _rglru_gates(p, x: torch.Tensor, cfg: ModelConfig):
    """x: (..., R) conv output -> (log_a, beta_x) with
    beta_x = sqrt(1 - a^2) * i_t * x, both float32."""
    # the products laid out as their biases are before the adds: torch
    # 2.11's DTensor cannot add a split bias to a partial sum
    lru = ("batch", "lru") if x.ndim == 2 else ("batch", "act_seq", "lru")
    r = torch.sigmoid(constrain(x @ p["w_a"].to(x.dtype), lru)
                      + p["b_a"].to(x.dtype))
    i = torch.sigmoid(constrain(x @ p["w_gx"].to(x.dtype), lru)
                      + p["b_gx"].to(x.dtype))
    log_a = -cfg.rglru_c * F.softplus(p["lambda_raw"].float()) * r.float()
    a2 = torch.exp(2.0 * log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a2, 1e-9, 1.0))
    bx = beta * (i.float() * x.float())
    return log_a, bx


def rglru_scan(log_a: torch.Tensor, bx: torch.Tensor,
               h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scan of h_t = a_t h_{t-1} + bx_t over axis 1, in log depth.

    log_a, bx: (B, L, R) float32.  Returns h (B, L, R).  Each doubling
    step combines element t with element t - off by the reference's
    associative operator ``(la1 + la2, b1 * exp(la2) + b2)``.
    """
    if h0 is not None:
        # fold h0 into the first step: h_1 = a_1 h0 + bx_1
        bx = bx.clone()
        bx[:, 0] = bx[:, 0] + torch.exp(log_a[:, 0]) * h0
    la, b = log_a, bx
    L = la.shape[1]
    off = 1
    while off < L:
        b = torch.cat([b[:, :off], b[:, :-off] * torch.exp(la[:, off:])
                       + b[:, off:]], dim=1)
        la = torch.cat([la[:, :off], la[:, :-off] + la[:, off:]], dim=1)
        off *= 2
    return b


def rglru_block_forward(p, x: torch.Tensor, cfg: ModelConfig, h0=None,
                        conv0=None, return_state: bool = False):
    """Full recurrent block.  x: (B, L, E) -> (B, L, E)."""
    y = layers.gelu(x @ p["w_y"].to(x.dtype))
    y = constrain(y, ("batch", "act_seq", "lru"))
    u = x @ p["w_in"].to(x.dtype)  # (B, L, R)
    u = constrain(u, ("batch", "act_seq", "lru"))
    W = p["conv_w"].shape[0]
    if conv0 is None:
        up = pad(u, (0, 0, W - 1, 0))
    else:
        up = torch.cat([conv0.to(u.dtype), u], dim=1)
    cw = p["conv_w"].to(x.dtype)
    L = u.shape[1]
    uc = up[:, 0:L] * cw[0][None, None]
    for i in range(1, W):
        uc = uc + up[:, i: i + L] * cw[i][None, None]
    log_a, bx = _rglru_gates(p, uc, cfg)
    h = rglru_scan(log_a, bx, h0)  # (B, L, R) float32
    out = (h.to(x.dtype) * y) @ p["w_out"].to(x.dtype)
    if return_state:
        return out, {"h": h[:, -1], "conv": up[:, -(W - 1):, :]}
    return out


def rglru_cache_init(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> Dict[str, torch.Tensor]:
    R = cfg.lru_width or cfg.d_model
    return {
        "h": torch.zeros((batch, R), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, CONV_WIDTH - 1, R), dtype=dtype,
                            device=device),
    }


def rglru_block_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
                       cfg: ModelConfig) -> Tuple[torch.Tensor, Dict]:
    """One-token step.  x: (B, 1, E); the cache is updated in place."""
    xt = x[:, 0]
    y = layers.gelu(xt @ p["w_y"].to(x.dtype))
    u = xt @ p["w_in"].to(x.dtype)  # (B, R)
    window = torch.cat([cache["conv"].to(u.dtype), u[:, None]], dim=1)
    uc = run_local(functools.partial(torch.einsum, "bwr,wr->br"),
                   (window, p["conv_w"].to(x.dtype)),
                   (("batch", None, "lru"), (None, "lru")),
                   (window.shape[0], window.shape[2]), ("batch", "lru"))
    log_a, bx = _rglru_gates(p, uc, cfg)
    h = torch.exp(log_a) * cache["h"] + bx
    out = ((h.to(x.dtype) * y) @ p["w_out"].to(x.dtype))[:, None]
    cache["h"].copy_(h)
    cache["conv"].copy_(window[:, 1:])
    return out, cache
