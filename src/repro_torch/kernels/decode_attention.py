"""Decode attention against a full bfloat16 KV cache: one launch a layer
and decode step.

``decode_attention(q, k, v, pos, scale)`` computes what
``models.attention.attend_full`` computes for one new token a row against
a full (not ring) cache, with rows ``j <= pos[b]`` valid:

    o[b, 0, h, g] = sum_j w_j v[b, j, h],
    w = bf16(softmax_j(float32(q[b, 0, h, g] . k[b, j, h]) * scale))

for q (B, 1, Kv, G, D) and k, v (B, S, Kv, D), all bfloat16, and returns
o as (B, 1, Kv, G, D) bfloat16.  On a CUDA tensor it launches the
hand-written Hopper kernel ``csrc/decode_attention.cu`` (built at first
use; the source says how it rounds at attend_full's rounding points and
reads each valid K and V row once), and a CUDA graph may capture it:
``pos`` is read on the device, so a replay serves every step.  It has no
plain version of its own: ``attend_full`` is one, and the routing keeps it.

``routes(...)`` is the routing of ``attention.gqa_decode``: the kernel
runs on the card where the input allows it (``takes``), by what the input
shows, and ``attend_full`` everywhere else.  Within the routes, ``decode_attention``
raises on anything the kernel does not take; it never falls back.

Counters, as the other wrappers keep them: ``launches`` (kernel launches
outside a capture), ``captured`` (launches recorded into a CUDA graph;
a graph launches each of them once per replay) and ``fallbacks`` (decode
calls on CUDA tensors that the routing sent to ``attend_full``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import Tensor

from repro_torch.distributed.partitioning import is_dtensor

THREADS = 128  # csrc/decode_attention.cu: DA_THREADS
WARPS = THREADS // 32
HEAD_DIMS = (64, 96, 128)  # the head dims the launcher takes
MAX_GROUPS = 8  # csrc: DA_MAX_G
# the G * S float32 scores a CTA keeps in shared memory (csrc: DA_SCORES_MAX)
SCORES_MAX = 32768
GRID_YZ_MAX = 65_535


@dataclasses.dataclass(frozen=True)
class Plan:
    """Launch geometry of one call: a CTA of ``THREADS`` threads for each
    (kv head, row), with ``smem`` bytes of dynamic shared memory."""

    grid: tuple
    threads: int
    smem: int

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1]


def plan(B: int, S: int, Kv: int, G: int, D: int) -> Plan:
    """The grid (Kv, B) and shared memory (the G * S scores, then the
    warps' (G, D) partial sums: csrc ``decode_attention_smem``)."""
    if D not in HEAD_DIMS or not 1 <= G <= MAX_GROUPS:
        raise ValueError(f"decode_attention: the kernel does not take "
                         f"head_dim {D} with {G} query groups a kv head "
                         f"(head_dim in {HEAD_DIMS}, 1 <= G <= {MAX_GROUPS})")
    if S < 1 or G * S > SCORES_MAX:
        raise ValueError(f"decode_attention: a cache of {S} rows x {G} "
                         f"groups exceeds {SCORES_MAX} scores a CTA")
    if B > GRID_YZ_MAX:
        raise ValueError(f"decode_attention: batch {B} exceeds the grid")
    return Plan((Kv, B), THREADS, (G * S + WARPS * G * D) * 4)


def bytes_bound(pos, S: int, Kv: int, D: int) -> int:
    """Bytes the kernel must read: each valid K and V row once (2 bytes
    an element), for positions ``pos`` (an iterable of ints)."""
    rows = sum(S if p < 0 else min(int(p) + 1, S) for p in pos)
    return 2 * rows * Kv * D * 2


def takes(q: Tensor, k: Tensor, v: Tensor, *, ring: bool, quantized: bool,
          softcap: Optional[float]) -> bool:
    """Whether the kernel takes a decode call, on any device: plain
    tensors (not DTensor), a full cache (not a ring) that is not int8
    (``kv_cache_quant``), no logit softcap, one query a row (Lq = 1), q, k
    and v bfloat16 (the kernel's rounding points are attend_full's in that
    precision), head dim 64, 96 or 128 with 1 to 8 query groups a kv head,
    and G * S scores that fit a CTA's shared memory."""
    if any(is_dtensor(t) for t in (q, k, v)):
        return False
    return (not ring and not quantized and softcap is None
            and q.dim() == 5 and k.dim() == 4 and q.shape[1] == 1
            and q.dtype == k.dtype == v.dtype == torch.bfloat16
            and q.shape[-1] in HEAD_DIMS and 1 <= q.shape[3] <= MAX_GROUPS
            and q.shape[3] * k.shape[1] <= SCORES_MAX)


def _on_card(t: Tensor) -> bool:
    return t.is_cuda


def routes(q: Tensor, k: Tensor, v: Tensor, *, ring: bool, quantized: bool,
           softcap: Optional[float]) -> bool:
    """Whether ``attention.gqa_decode`` runs this kernel: on CUDA tensors
    that it ``takes``.  A decode call on CUDA tensors that it does not
    take is counted in ``fallbacks`` and runs ``attend_full``."""
    if not _on_card(q):
        return False
    if takes(q, k, v, ring=ring, quantized=quantized, softcap=softcap):
        return True
    decode_attention.fallbacks += 1
    return False


def _check(q: Tensor, k: Tensor, v: Tensor, pos: Tensor) -> None:
    if q.dim() != 5 or q.shape[1] != 1:
        raise ValueError(f"q must be (B, 1, Kv, G, D), got {tuple(q.shape)}")
    B, _, Kv, G, D = q.shape
    if k.dim() != 4 or k.shape[0] != B or tuple(k.shape[2:]) != (Kv, D):
        raise ValueError(f"k must be (B={B}, S, Kv={Kv}, D={D}), got "
                         f"{tuple(k.shape)}")
    if v.shape != k.shape:
        raise ValueError(f"v {tuple(v.shape)} != k {tuple(k.shape)}")
    if pos.shape != (B,):
        raise ValueError(f"pos must be ({B},), got {tuple(pos.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    if pos.dtype != torch.int64:
        raise TypeError(f"pos must be int64, got {pos.dtype}")
    for name, t in (("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"the cache's {name} must be contiguous and "
                             f"16-byte aligned")
    if any(t.device != q.device for t in (k, v, pos)):
        raise ValueError("decode_attention: every tensor must be on q's "
                         "device")


def decode_attention(q: Tensor, k: Tensor, v: Tensor, pos: Tensor,
                     scale: float) -> Tensor:
    """(B, 1, Kv, G, D) bfloat16: ``attend_full``'s output for one token a
    row at ``pos`` (B,) against the full cache ``k``, ``v`` (module
    docstring).  CUDA tensors only."""
    if not _on_card(q):
        raise ValueError("decode_attention runs on the card only; the "
                         "routing keeps attend_full elsewhere")
    _check(q, k, v, pos)
    out = _launch(q, k, v, pos, scale)
    if q.is_cuda and torch.cuda.is_current_stream_capturing():
        decode_attention.captured += 1
    else:
        decode_attention.launches += 1
    return out


def _launch(q: Tensor, k: Tensor, v: Tensor, pos: Tensor,
            scale: float) -> Tensor:
    """Launch ``csrc/decode_attention.cu`` on checked input; counts
    nothing."""
    B, _, Kv, G, D = q.shape
    S = k.shape[1]
    geo = plan(B, S, Kv, G, D)  # raises on a shape the kernel lacks
    q = q.contiguous()
    out = torch.empty((B, 1, Kv, G, D), dtype=torch.bfloat16, device=q.device)

    from repro_torch.kernels import _build

    launch = _build.load("decode_attention")
    rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
                out.data_ptr(), B, S, Kv, G, D, scale,
                torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc} (plan {geo})")
    return out


decode_attention.launches = 0  # kernel launches since the last reset
# launches recorded into CUDA graphs being captured since the last reset
decode_attention.captured = 0
# decode calls on CUDA tensors that the routing sent to attend_full
decode_attention.fallbacks = 0
