"""Absorbed MLA decode against the full bfloat16 latent cache: one launch
a layer and decode step.

``mla_decode(q_eff, q_rope, c_kv, k_rope, pos, scale)`` computes what
``models.attention._mla_latent`` computes for one new token a row against
the latent cache, with rows ``j <= pos[b]`` valid:

    s_j = (float32(q_eff . c_kv_j) + float32(q_rope . k_rope_j)) * scale
    w   = bf16(softmax_j(s_j))
    ctx = bf16(sum_j w_j c_kv_j)        (summed in float32)

for q_eff (B, 1, H, 512), q_rope (B, 1, H, 64), c_kv (B, S, 512) and
k_rope (B, S, 64), all bfloat16, and returns ctx as (B, 1, H, 512)
bfloat16.  On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/mla_decode.cu`` (built at first use; the source says how it rounds
at the plain version's rounding points and reads each valid cache row
once), and a CUDA graph may capture it: ``pos`` is read on the device, so
a replay serves every step.  ``_mla_latent`` is its plain version, and
the routing keeps it.

``routes(...)`` is the routing of ``attention.mla_decode``: the kernel
runs on the card where the input allows it (``takes``), by what the input
shows, and ``_mla_latent`` everywhere else.  Within the routes,
``mla_decode`` raises on anything the kernel does not take; it never
falls back.

Counters, as the other wrappers keep them: ``launches`` (kernel launches
outside a capture), ``captured`` (launches recorded into a CUDA graph; a
graph launches each of them once per replay) and ``fallbacks`` (absorbed
decode calls on CUDA tensors that the routing sent to ``_mla_latent``).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import torch
from torch import Tensor

from repro_torch.distributed.partitioning import is_dtensor

THREADS = 256  # csrc/mla_decode.cu: MLA_THREADS
CLUSTER = 8  # CTAs a (row, 16 heads), one cluster (MLA_CLUSTER)
HEADS = 16  # heads a CTA, the M of its products (MLA_HEADS)
RANK = 512  # the kv_lora_rank the kernel takes (MLA_RANK)
ROPE = 64  # the qk_rope_head_dim it takes (MLA_ROPE)
GROUP = 64  # cache rows a copy group (MLA_GROUP)
GROUPS_MAX = 3  # groups a CTA holds in shared memory (MLA_GROUPS_MAX)
ROWS_MAX = CLUSTER * GROUP * GROUPS_MAX  # the longest cache: 1,536 rows
GRID_YZ_MAX = 65_535
ROW_BYTES = (RANK + ROPE) * 2  # a cache row: c_kv and k_rope, bfloat16


@dataclasses.dataclass(frozen=True)
class Plan:
    """Launch geometry of one call: a cluster of ``cluster`` CTAs of
    ``threads`` threads for each (row, 16 heads), each CTA holding
    ``rows`` cache rows in ``smem`` bytes of dynamic shared memory."""

    grid: tuple
    threads: int
    cluster: int
    rows: int
    smem: int

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def plan(B: int, S: int, H: int, rank: int = RANK, rope: int = ROPE) -> Plan:
    """The grid (CLUSTER, H / 16, B), and a CTA's share of the cache: S /
    CLUSTER rows rounded up to whole groups of GROUP, all of them in shared
    memory (csrc ``mla_decode_launch`` computes the same)."""
    if (rank, rope) != (RANK, ROPE) or H < HEADS or H % HEADS:
        raise ValueError(f"mla_decode: the kernel does not take rank {rank}, "
                         f"rope {rope} with {H} heads (rank {RANK}, rope "
                         f"{ROPE}, heads a multiple of {HEADS})")
    if not 1 <= S <= ROWS_MAX:
        raise ValueError(f"mla_decode: a cache of {S} rows is outside the "
                         f"1 .. {ROWS_MAX} rows a cluster holds")
    if B > GRID_YZ_MAX or H // HEADS > GRID_YZ_MAX:
        raise ValueError(f"mla_decode: batch {B} x {H} heads exceeds the grid")
    rows = -(-(-(-S // CLUSTER)) // GROUP) * GROUP
    return Plan((CLUSTER, H // HEADS, B), THREADS, CLUSTER, rows, smem(rows))


def smem(rows: int) -> int:
    """Dynamic shared memory of a CTA holding ``rows`` cache rows (csrc
    ``Layout``): the c_kv rows, then the k_rope rows' region, which the
    weights (16 x rows bf16, at least a partial context), the row's max
    and sum and the peers' partial contexts of the CTA's 64 columns
    (CLUSTER - 1 slots of 16 x 64 float32) reuse; then the three
    exchanges' 8-byte barriers."""
    slot = HEADS * 64 * 4
    return (rows * RANK * 2 + max(rows * HEADS * 2, slot) + 2 * HEADS * 4
            + (CLUSTER - 1) * slot + 3 * 8)


def valid_rows(pos: Iterable[int], S: int) -> int:
    """Cache rows the rows at ``pos`` attend to: ``min(p + 1, S)`` a row,
    all ``S`` for a row with no valid position (``p < 0``)."""
    return sum(S if p < 0 else min(int(p) + 1, S) for p in pos)


def bytes_bound(pos: Iterable[int], S: int) -> int:
    """Bytes the kernel must read: each valid c_kv and k_rope row once
    (2 bytes an element), for positions ``pos`` (an iterable of ints)."""
    return valid_rows(pos, S) * ROW_BYTES


def bytes_two_reads(pos: Iterable[int], S: int) -> int:
    """Bytes of a design that reads the valid c_kv rows a second time for
    the context: ``bytes_bound`` plus c_kv once more."""
    return bytes_bound(pos, S) + valid_rows(pos, S) * RANK * 2


def takes(q: Tensor, q_rope: Tensor, c_kv: Tensor, k_rope: Tensor) -> bool:
    """Whether the kernel takes an absorbed decode call, on any device:
    plain tensors (not DTensor), one query a row (Lq = 1), the query
    ``q`` (B, 1, H, .), q_rope, c_kv and k_rope bfloat16 (the kernel's
    rounding points are the plain version's in that precision), rank 512
    and rope 64 with H a multiple of 16, and a cache of at most ROWS_MAX
    rows (what a cluster holds in shared memory)."""
    ts = (q, q_rope, c_kv, k_rope)
    if any(is_dtensor(t) for t in ts):
        return False
    if not (q.dim() == q_rope.dim() == 4 and c_kv.dim() == k_rope.dim() == 3):
        return False
    B, Lq, H = q.shape[:3]
    return (Lq == 1 and all(t.dtype == torch.bfloat16 for t in ts)
            and tuple(q_rope.shape[:3]) == (B, 1, H)
            and c_kv.shape[0] == k_rope.shape[0] == B
            and c_kv.shape[1] == k_rope.shape[1]
            and c_kv.shape[-1] == RANK and k_rope.shape[-1] == ROPE
            and q_rope.shape[-1] == ROPE and H >= HEADS and H % HEADS == 0
            and 1 <= c_kv.shape[1] <= ROWS_MAX and B <= GRID_YZ_MAX)


def _on_card(t: Tensor) -> bool:
    return t.is_cuda


def routes(q: Tensor, q_rope: Tensor, c_kv: Tensor, k_rope: Tensor) -> bool:
    """Whether ``attention.mla_decode`` runs this kernel: on CUDA tensors
    that it ``takes``.  An absorbed decode call on CUDA tensors that it
    does not take (MiniCPM3's rank 256 with 40 heads, a longer cache, ...)
    is counted in ``fallbacks`` and runs ``_mla_latent``."""
    if not _on_card(q):
        return False
    if takes(q, q_rope, c_kv, k_rope):
        return True
    mla_decode.fallbacks += 1
    return False


def _check(q: Tensor, q_rope: Tensor, c_kv: Tensor, k_rope: Tensor,
           pos: Tensor) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q_eff must be (B, 1, H, rank), got {tuple(q.shape)}")
    B, _, H, r = q.shape
    if q_rope.dim() != 4 or tuple(q_rope.shape[:3]) != (B, 1, H):
        raise ValueError(f"q_rope must be (B={B}, 1, H={H}, rope), got "
                         f"{tuple(q_rope.shape)}")
    if c_kv.dim() != 3 or c_kv.shape[0] != B or c_kv.shape[2] != r:
        raise ValueError(f"c_kv must be (B={B}, S, {r}), got "
                         f"{tuple(c_kv.shape)}")
    if tuple(k_rope.shape) != (B, c_kv.shape[1], q_rope.shape[3]):
        raise ValueError(f"k_rope must be (B={B}, S={c_kv.shape[1]}, "
                         f"{q_rope.shape[3]}), got {tuple(k_rope.shape)}")
    if pos.shape != (B,):
        raise ValueError(f"pos must be ({B},), got {tuple(pos.shape)}")
    for name, t in (("q_eff", q), ("q_rope", q_rope), ("c_kv", c_kv),
                    ("k_rope", k_rope)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} must be bfloat16, got {t.dtype}")
    if pos.dtype != torch.int64:
        raise TypeError(f"pos must be int64, got {pos.dtype}")
    for name, t in (("c_kv", c_kv), ("k_rope", k_rope)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"the cache's {name} must be contiguous and "
                             f"16-byte aligned")
    if any(t.device != q.device for t in (q_rope, c_kv, k_rope, pos)):
        raise ValueError("mla_decode: every tensor must be on q_eff's device")


def mla_decode(q: Tensor, q_rope: Tensor, c_kv: Tensor, k_rope: Tensor,
               pos: Tensor, scale: float) -> Tensor:
    """(B, 1, H, rank) bfloat16: ``_mla_latent``'s context for one token a
    row at ``pos`` (B,) against the full latent cache ``c_kv``, ``k_rope``
    (module docstring).  CUDA tensors only."""
    if not _on_card(q):
        raise ValueError("mla_decode runs on the card only; the routing "
                         "keeps _mla_latent elsewhere")
    _check(q, q_rope, c_kv, k_rope, pos)
    out = _launch(q, q_rope, c_kv, k_rope, pos, scale)
    if q.is_cuda and torch.cuda.is_current_stream_capturing():
        mla_decode.captured += 1
    else:
        mla_decode.launches += 1
    return out


def _launch(q: Tensor, q_rope: Tensor, c_kv: Tensor, k_rope: Tensor,
            pos: Tensor, scale: float) -> Tensor:
    """Launch ``csrc/mla_decode.cu`` on checked input; counts nothing."""
    B, _, H, r = q.shape
    S, dr = c_kv.shape[1], k_rope.shape[2]
    geo = plan(B, S, H, r, dr)  # raises on a shape the kernel lacks
    q, q_rope, pos = q.contiguous(), q_rope.contiguous(), pos.contiguous()
    out = torch.empty((B, 1, H, r), dtype=torch.bfloat16, device=q.device)

    from repro_torch.kernels import _build

    launch = _build.load("mla_decode")
    rc = launch(q.data_ptr(), q_rope.data_ptr(), c_kv.data_ptr(),
                k_rope.data_ptr(), pos.data_ptr(), out.data_ptr(), B, S, H,
                r, dr, scale, torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"mla_decode kernel launch failed: CUDA error "
                           f"{rc} (plan {geo})")
    return out


mla_decode.launches = 0  # kernel launches since the last reset
# launches recorded into CUDA graphs being captured since the last reset
mla_decode.captured = 0
# absorbed decode calls on CUDA tensors that the routing sent to _mla_latent
mla_decode.fallbacks = 0
