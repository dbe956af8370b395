"""Shared neural layers: norms, RoPE, MLPs, embeddings.

Every init function takes an ``Init`` (the generator, device and dtype of
one model's initialisation) and returns a dict of tensors, or of their
logical axes in ``Init``'s axes mode (each draw names its dims).  Parameters
use the reference's layouts and distributions; draws come from the
port's own generator, so values differ from the reference's.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.partitioning import constrain


class Init:
    """Where and how a model's parameters are drawn.

    On the ``meta`` device nothing is drawn: leaves carry shape and dtype
    only (``Model.abstract``, ``param_count``).  In the axes mode
    (``Init.logical_axes()``) every draw returns the logical axes it is
    given, one name per dim, in place of a tensor, and ``stacked`` prepends
    ``"layers"``: the params' partitioning names (``Model.logical_axes``).
    """

    def __init__(self, generator: Optional[torch.Generator],
                 device: torch.device, dtype: torch.dtype = torch.float32,
                 lead: Tuple[int, ...] = (), names: bool = False):
        self.gen = generator
        self.device = torch.device(device)
        self.dtype = dtype
        self.lead = tuple(lead)
        self.names = names

    @classmethod
    def logical_axes(cls) -> "Init":
        """The axes mode: draws return their logical axes."""
        return cls(None, torch.device("meta"), names=True)

    def stacked(self, n: int) -> "Init":
        """The same draws with a leading layer axis of n on every leaf."""
        return Init(self.gen, self.device, self.dtype, (n,) + self.lead,
                    self.names)

    @property
    def meta(self) -> bool:
        return self.device.type == "meta"

    def _axes(self, axes) -> Tuple[str, ...]:
        return ("layers",) * len(self.lead) + tuple(axes)

    def _empty(self, shape) -> torch.Tensor:
        return torch.empty(self.lead + tuple(shape), dtype=torch.float32,
                           device=self.device)

    def uniform(self, shape, lo: float, hi: float, *, axes):
        """U[lo, hi) drawn in float32, then cast to the param dtype."""
        if self.names:
            return self._axes(axes)
        t = self._empty(shape)
        if not self.meta:
            t.uniform_(lo, hi, generator=self.gen)
        return t.to(self.dtype)

    def normal(self, shape, std: float, *, axes):
        """N(0, 1) drawn in float32, cast to the param dtype, times std."""
        if self.names:
            return self._axes(axes)
        t = self._empty(shape)
        if not self.meta:
            t.normal_(generator=self.gen)
        return t.to(self.dtype) * std

    def full(self, shape, value: float, *, axes):
        if self.names:
            return self._axes(axes)
        return torch.full(self.lead + tuple(shape), value, dtype=self.dtype,
                          device=self.device)

    def map(self, leaf, fn):
        """``fn(leaf)``: a leaf derived from a draw; in the axes mode the
        draw's axes, unchanged."""
        return leaf if self.names else fn(leaf)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


# ---------------------------------------------------------------- helpers
def dense_init(init: Init, shape: Sequence[int], axes: Sequence[str],
               fan_in_dims: int = 1):
    """fan-in-scaled uniform init; axes = logical names, one per dim."""
    fan_in = math.prod(shape[:fan_in_dims])
    scale = 1.0 / math.sqrt(fan_in)
    return init.uniform(shape, -scale, scale, axes=axes)


# ---------------------------------------------------------------- norms
def norm_init(init: Init, d: int, kind: str):
    p = {"scale": init.full((d,), 1.0, axes=("embed",))}
    if kind == "layernorm":
        p["bias"] = init.full((d,), 0.0, axes=("embed",))
    return p


def apply_norm(p, x: torch.Tensor, kind: str, eps: float) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    elif kind == "layernorm":
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:
        raise ValueError(kind)
    return y.to(x.dtype)


# ---------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, rope_pct: float = 1.0,
               device=None):
    rot_dim = int(head_dim * rope_pct) // 2 * 2
    exps = torch.arange(0, rot_dim, 2, dtype=torch.float32, device=device)
    inv = 1.0 / torch.pow(theta, exps / rot_dim)  # float32, as the reference
    return inv, rot_dim


def yarn_mscale(factor: float, mscale: float) -> float:
    """YaRN's attention temperature: ``0.1 * mscale * ln(factor) + 1``, and
    1 where ``factor`` <= 1."""
    if factor <= 1:
        return 1.0
    return 0.1 * mscale * math.log(factor) + 1.0


def yarn_inv_freq(dim: int, theta: float, factor: float,
                  original_max_pos: int, beta_fast: float, beta_slow: float,
                  device=None) -> torch.Tensor:
    """YaRN's inverse frequencies of ``dim`` rotary dims (DeepSeek-V2's
    form): each pair's frequency ramps linearly, between the pairs that
    turn ``beta_fast`` and ``beta_slow`` times over ``original_max_pos``
    positions, from theta's own (the fast pairs, kept) to theta's over
    ``factor`` (the slow pairs, interpolated).  Float32, on ``device``."""
    def turns_dim(turns):
        return (dim * math.log(original_max_pos / (turns * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(math.floor(turns_dim(beta_fast)), 0)
    high = min(math.ceil(turns_dim(beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    extra = 1.0 / torch.pow(theta, exps)
    inter = 1.0 / (factor * torch.pow(theta, exps))
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=device) - low) / (high - low),
                       0, 1)
    keep = 1.0 - ramp
    return inter * (1 - keep) + extra * keep


def apply_rope(
    x: torch.Tensor,  # (..., L, H, D)
    positions: torch.Tensor,  # (..., L) int
    theta: float,
    rope_pct: float = 1.0,
    inv_freq: Optional[torch.Tensor] = None,
    cos_scale: float = 1.0,
) -> torch.Tensor:
    """Rotary embedding on the first ``rope_pct`` of each head's dims
    (halves rotated as a pair); the rest pass through.  ``inv_freq`` (the
    first ``2 * len(inv_freq)`` dims rotated) replaces theta's, and
    ``cos_scale`` scales cos and sin (YaRN)."""
    D = x.shape[-1]
    if inv_freq is None:
        inv, rot_dim = rope_freqs(D, theta, rope_pct, device=x.device)
    else:
        inv, rot_dim = inv_freq, 2 * inv_freq.shape[0]
    if rot_dim == 0:
        return x
    ang = positions[..., None].float() * inv  # (..., L, rot/2)
    cos = torch.cos(ang)[..., None, :]  # (..., L, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    if cos_scale != 1.0:
        cos, sin = cos * cos_scale, sin * cos_scale
    xr, xp = x[..., :rot_dim], x[..., rot_dim:]
    x1, x2 = xr[..., : rot_dim // 2], xr[..., rot_dim // 2:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1.to(x.dtype), y2.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------- mlp
def mlp_init(init: Init, d_model: int, d_ff: int, kind: str):
    p = {}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = dense_init(init, (d_model, d_ff), ("embed", "mlp"))
    p["w_up"] = dense_init(init, (d_model, d_ff), ("embed", "mlp"))
    p["w_down"] = dense_init(init, (d_ff, d_model), ("mlp", "embed"))
    return p


def apply_mlp(p, x: torch.Tensor, kind: str) -> torch.Tensor:
    up = x @ p["w_up"].to(x.dtype)
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"].to(x.dtype)) * up
    elif kind == "geglu":
        h = gelu(x @ p["w_gate"].to(x.dtype)) * up
    elif kind == "gelu":
        h = gelu(up)
    else:
        raise ValueError(kind)
    h = constrain(h, ("batch", "act_seq", "mlp"))
    return h @ p["w_down"].to(x.dtype)


# ---------------------------------------------------------------- embed
def embedding_init(init: Init, vocab: int, d_model: int):
    return {"table": init.normal((vocab, d_model), 0.02,
                                 axes=("vocab", "embed"))}


def unembed(p_head: torch.Tensor, x: torch.Tensor,
            softcap: Optional[float]) -> torch.Tensor:
    logits = x @ p_head.to(x.dtype)
    if softcap is not None:
        logits = softcap * torch.tanh(logits.float() / softcap)
    return logits
