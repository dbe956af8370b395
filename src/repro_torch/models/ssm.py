"""Mamba2 — SSD (state-space duality) layer, chunked matmul formulation.

Prefill uses the chunked SSD algorithm (Dao & Gu 2024): the sequence is
split into chunks of Q tokens; intra-chunk work is a masked quadratic
matmul, inter-chunk work is a length-L/Q linear recurrence over per-chunk
states.  Decode uses the O(1) recurrent form with (conv_state, ssm_state)
carried in the cache.  The einsums run in float32, as the reference's
``preferred_element_type=float32`` asks.

Projections are separate params (w_z/w_x/w_B/w_C/w_dt and per-part
convs), in the reference's layout.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.partitioning import (constrain, merge_dims,
                                                  pad, run_local, unflatten)
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init


def ssm_init(init: Init, cfg: ModelConfig):
    E = cfg.d_model
    DI = cfg.d_inner
    H, N, G = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_ngroups
    W = cfg.ssm_conv_width
    a_log = init.uniform((H,), 1.0, 16.0, axes=("heads",))
    dt = init.uniform((H,), 1e-3, 1e-1, axes=("heads",))
    return {
        "w_z": layers.dense_init(init, (E, DI), ("embed", "inner")),
        "w_x": layers.dense_init(init, (E, DI), ("embed", "inner")),
        "w_B": layers.dense_init(init, (E, G, N), ("embed", "groups", "state")),
        "w_C": layers.dense_init(init, (E, G, N), ("embed", "groups", "state")),
        "w_dt": layers.dense_init(init, (E, H), ("embed", "heads")),
        # depthwise causal convs (width W) on x, B, C streams
        "conv_x": init.normal((W, DI), 0.1, axes=("conv_w", "inner")),
        "conv_B": init.normal((W, G * N), 0.1, axes=("conv_w", "state")),
        "conv_C": init.normal((W, G * N), 0.1, axes=("conv_w", "state")),
        # per-head decay / skip / dt bias
        "A_log": init.map(a_log, lambda u: torch.log(u.float()).to(init.dtype)),
        "D": init.full((H,), 1.0, axes=("heads",)),
        "dt_bias": init.map(dt, lambda u: torch.log(torch.expm1(u.float()))
                            .to(init.dtype)),
        "norm_scale": init.full((DI,), 1.0, axes=("inner",)),
        "out_proj": layers.dense_init(init, (DI, E), ("inner", "embed")),
    }


def _repeat(t: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    """``jnp.repeat(t, rep, axis=dim)`` (each entry ``rep`` times in a
    row), as a view expanded and flattened: no read of a repeat count."""
    if rep == 1:
        return t
    shape = list(t.shape)
    out = t.unsqueeze(dim + 1).expand(*shape[:dim + 1], rep, *shape[dim + 1:])
    return out.flatten(dim, dim + 1)


def _flat_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., E) times w (E, G, N), its last two dims flattened:
    (..., G * N).  Over DTensors w is flattened shard by shard, so the
    product never unflattens a split dim."""
    return x @ merge_dims(w, 1, 2)


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along axis 1.  x: (B, L, D), w: (W, D)."""
    W = w.shape[0]
    L = x.shape[1]
    xp = pad(x, (0, 0, W - 1, 0))
    out = xp[:, 0:L, :] * w[0][None, None, :]
    for i in range(1, W):
        out = out + xp[:, i: i + L, :] * w[i][None, None, :]
    return out


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """(..., Q) -> (..., Q, Q) lower-triangular segment sums."""
    c = torch.cumsum(dA, dim=-1)
    diff = c[..., :, None] - c[..., None, :]
    Q = dA.shape[-1]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dA.device))
    return torch.where(mask, diff, -math.inf)


def ssd_chunked(
    xdt: torch.Tensor,  # (B, L, H, P) inputs pre-multiplied by dt
    dA: torch.Tensor,  # (B, L, H) = dt * A (negative)
    Bm: torch.Tensor,  # (B, L, G, N)
    Cm: torch.Tensor,  # (B, L, G, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,  # initial state (B, H, P, N)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.  Returns (y (B,L,H,P), final_state (B,H,P,N)),
    both float32."""
    B, L, H, P = xdt.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = min(chunk, L)
    pad = (-L) % Q
    if pad:
        xdt = F.pad(xdt, (0, 0, 0, 0, 0, pad))
        dA = F.pad(dA, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    Lp = L + pad
    nc = Lp // Q
    xc = xdt.reshape(B, nc, Q, H, P).float()
    dAc = dA.reshape(B, nc, Q, H).permute(0, 3, 1, 2)  # (B, H, nc, Q)
    rep = H // G  # heads per group
    # expand B/C from groups to heads: (B, nc, Q, G, N) -> (B, nc, Q, H, N)
    Bh = _repeat(Bm.reshape(B, nc, Q, G, N), rep, 3).float()
    Ch = _repeat(Cm.reshape(B, nc, Q, G, N), rep, 3).float()

    # --- intra-chunk (diag) ---
    Lmat = torch.exp(_segsum(dAc))  # (B, H, nc, Q, Q)
    scores = torch.einsum("bclhn,bcshn->bhcls", Ch, Bh)
    y_diag = torch.einsum("bhcls,bhcls,bcshp->bclhp", scores, Lmat, xc)

    # --- chunk states ---
    csum = torch.cumsum(dAc, dim=-1)  # (B, H, nc, Q)
    decay_states = torch.exp(csum[..., -1:] - csum)  # (B, H, nc, Q)
    states = torch.einsum(
        "bcshn,bhcs,bcshp->bchpn", Bh, decay_states, xc
    )  # (B, nc, H, P, N)

    # --- inter-chunk recurrence ---
    chunk_decay = torch.exp(csum[..., -1])  # (B, H, nc)
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=xdt.device)
         if h0 is None else h0.float())
    prevs = []
    for c in range(nc):
        prevs.append(h)
        h = h * chunk_decay[:, :, c, None, None] + states[:, c]
    prev_states = torch.stack(prevs, dim=1)  # (B, nc, H, P, N)

    # --- inter-chunk (off-diag) outputs ---
    state_decay = torch.exp(csum)  # (B, H, nc, Q) decay from chunk start
    y_off = torch.einsum(
        "bclhn,bchpn,bhcl->bclhp", Ch, prev_states, state_decay
    )

    y = (y_diag + y_off).reshape(B, Lp, H, P)[:, :L]
    return y, h


def _local_ssd(xdt, dA, Bm, Cm, chunk: int, h0=None):
    """``ssd_chunked``; over DTensors each device scans its batch block
    (and its heads, when one group serves them all)."""
    B, L, H, P = xdt.shape
    N = Bm.shape[3]
    heads = "heads" if Bm.shape[2] == 1 else None
    return run_local(
        lambda *a: ssd_chunked(*a[:4], chunk, a[4]), (xdt, dA, Bm, Cm, h0),
        (("batch", None, heads, None), ("batch", None, heads),
         ("batch", None, None, None), ("batch", None, None, None),
         None if h0 is None else ("batch", heads, None, None)),
        ((B, L, H, P), (B, H, P, N)),
        (("batch", None, heads, None), ("batch", heads, None, None)))


def _split_heads(t: torch.Tensor, H: int, P: int) -> torch.Tensor:
    return unflatten(t, -1, (H, P))


def _gated_norm(y, z, p, dtype):
    """Mamba2's gated RMSNorm: rmsnorm(y * silu(z)) * norm_scale."""
    y = y * F.silu(z)
    yf = y.float()
    return (
        yf * torch.rsqrt(torch.mean(yf ** 2, -1, keepdim=True) + 1e-6)
        * p["norm_scale"].float()
    ).to(dtype)


def _streams(p, x):
    """The pre-conv x, B and C streams (B, L, ·) of the block input."""
    B, L, _ = x.shape
    xs = x @ p["w_x"].to(x.dtype)
    Bs = _flat_proj(x, p["w_B"].to(x.dtype))  # (B, L, G * N)
    Cs = _flat_proj(x, p["w_C"].to(x.dtype))
    return xs, Bs, Cs


def ssm_forward(p, x: torch.Tensor, cfg: ModelConfig, h0=None,
                return_state: bool = False):
    """x: (B, L, E) -> (B, L, E).  Training / prefill path."""
    H, P, N, G = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    B, L, _ = x.shape
    z = x @ p["w_z"].to(x.dtype)  # (B, L, DI)
    xs, Bs, Cs = _streams(p, x)
    dt_raw = x @ p["w_dt"].to(x.dtype)  # (B, L, H)

    xs = F.silu(_causal_conv(xs, p["conv_x"].to(x.dtype)))
    xs = constrain(xs, ("batch", "act_seq", "inner"))
    Bs = F.silu(_causal_conv(Bs, p["conv_B"].to(x.dtype))).reshape(B, L, G, N)
    Cs = F.silu(_causal_conv(Cs, p["conv_C"].to(x.dtype))).reshape(B, L, G, N)
    Bs = constrain(Bs, ("batch", "act_seq", "groups", "state"))
    Cs = constrain(Cs, ("batch", "act_seq", "groups", "state"))

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())  # (B, L, H)
    A = -torch.exp(p["A_log"].float())  # (H,)
    dA = dt * A  # (B, L, H)

    xh = _split_heads(xs, H, P)
    xdt = xh.float() * dt[..., None]
    y, state = _local_ssd(xdt, dA, Bs, Cs, cfg.ssm_chunk, h0)
    y = y + xh.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(B, L, H * P).to(x.dtype)
    out = _gated_norm(y, z, p, x.dtype) @ p["out_proj"].to(x.dtype)
    if return_state:
        return out, state
    return out


def ssm_cache_init(cfg: ModelConfig, batch: int, dtype,
                   device=None) -> Dict[str, torch.Tensor]:
    H, P, N, G = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    W = cfg.ssm_conv_width

    def z(shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return {
        "conv_x": z((batch, W - 1, cfg.d_inner)),
        "conv_B": z((batch, W - 1, G * N)),
        "conv_C": z((batch, W - 1, G * N)),
        "state": z((batch, H, P, N), torch.float32),
    }


def _conv_step(cache_part: torch.Tensor, new: torch.Tensor, w: torch.Tensor):
    """One causal-conv step.  cache: (B, W-1, D) previous inputs; the
    window shifts into it in place."""
    window = torch.cat([cache_part.to(new.dtype), new[:, None, :]], dim=1)
    out = run_local(functools.partial(torch.einsum, "bwd,wd->bd"),
                    (window, w), (("batch", None, None), (None, None)),
                    (window.shape[0], window.shape[2]), ("batch", None))
    cache_part.copy_(window[:, 1:, :])
    return out


def _state_step(state, dA, xh, Bh, dt, Ch):
    """The SSD state advanced one token in place; returns its readout
    (B, H, P)."""
    new = state * dA[..., None, None] + torch.einsum(
        "bhp,bhn,bh->bhpn", xh, Bh, dt
    )
    state.copy_(new)
    return torch.einsum("bhpn,bhn->bhp", new, Ch)


def ssm_decode(p, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               cfg: ModelConfig) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One-token decode.  x: (B, 1, E); the cache is updated in place."""
    H, P, N, G = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    B = x.shape[0]
    xt = x[:, 0]
    z = xt @ p["w_z"].to(x.dtype)
    xs = xt @ p["w_x"].to(x.dtype)
    Bs = _flat_proj(xt, p["w_B"].to(x.dtype))  # (B, G * N)
    Cs = _flat_proj(xt, p["w_C"].to(x.dtype))
    dt_raw = xt @ p["w_dt"].to(x.dtype)

    xs = F.silu(_conv_step(cache["conv_x"], xs, p["conv_x"].to(x.dtype)))
    Bs = F.silu(_conv_step(cache["conv_B"], Bs, p["conv_B"].to(x.dtype)))
    Cs = F.silu(_conv_step(cache["conv_C"], Cs, p["conv_C"].to(x.dtype)))
    Bs = Bs.reshape(B, G, N)
    Cs = Cs.reshape(B, G, N)

    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())  # (B, H)
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A)  # (B, H)

    xh = unflatten(xs, 1, (H, P)).float()
    rep = H // G
    Bh = _repeat(Bs, rep, 1).float()  # (B, H, N)
    Ch = _repeat(Cs, rep, 1).float()
    # over DTensors each device steps its block of the cache's layout
    heads, hn = ("batch", "heads"), ("batch", "heads", "state")
    y = run_local(
        _state_step, (cache["state"], dA, xh, Bh, dt, Ch),
        (("batch", "heads", "head_dim", "state"), heads,
         ("batch", "heads", "head_dim"), hn, heads, hn),
        xh.shape, ("batch", "heads", "head_dim"), summed=(5, 2))
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(B, H * P).to(x.dtype)
    out = (_gated_norm(y, z, p, x.dtype) @ p["out_proj"].to(x.dtype))[:, None, :]
    return out, cache
