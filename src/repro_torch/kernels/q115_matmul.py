"""Q1.15 fixed-point matrix product (paper §4.3 number format).

``q115_matmul`` multiplies int16 Q1.15 codes (M, K) by (K, N) with the
FPGA's dataflow: each Q2.30 product is rescaled to Q1.15 with
round-to-nearest, ``(x * w + 2^14) >> 15``, *before* the int32 sum, so a
fan-in-4096 sum fits the paper's 28-bit intermediate.  The output
saturates to int16, or is the raw int32 sum with ``saturate=False``.  On
a CUDA tensor it launches the hand-written Hopper kernel
``csrc/q115_matmul.cu`` (built at first use) or raises; on a CPU tensor
it runs the plain versions ``q115_matmul_ref`` / ``q115_matmul_acc_ref``,
which are bit-exact against the reference's namesakes, and so is the
kernel.  ``plan`` is the kernel's launch geometry (tiles and split-K).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels.spike_matmul import _check, k_chunk

Tensor = torch.Tensor
FRAC_BITS = 15
_ROUND = 1 << (FRAC_BITS - 1)
# the kernel's tile (csrc/q115_matmul.cu: Q_TM rows a warp, 8 or 4 warps a
# CTA, Q_BN columns), its slab (Q_BK), the granularity of a K split
# (Q_KSTEP), the largest cluster that reduces K splits (Q_CLUSTER_MAX),
# and the CTAs the plan aims at: two an SM of an H100
ROWS_PER_WARP, TILE_N, TILE_K = 8, 128, 32
K_STEP = 8
CLUSTER_MAX = 8
SMS = 132
TARGET_CTAS = 2 * SMS
GRID_YZ_MAX = 65535
INT_MAX = 2**31 - 1


@dataclass(frozen=True)
class Plan:
    """Launch geometry of one ``q115_matmul`` call: a grid of (n_tiles,
    m_tiles, split) CTAs of ``warps`` warps, each summing
    ``k_per_split`` of K (the last split the rest) for one
    (8 * warps) x TILE_N output tile.  The K splits of a tile reduce in
    shared memory across a cluster of ``cluster`` CTAs, and across
    clusters by atomicAdd into a zeroed output."""

    warps: int
    m_tiles: int
    n_tiles: int
    split: int  # CTAs along K
    k_per_split: int  # a multiple of K_STEP; whole slabs once above TILE_K
    cluster: int  # CTAs along K that reduce in shared memory: the launcher
    # takes every split of a saturating product, else 1

    @property
    def ctas(self) -> int:
        return self.m_tiles * self.n_tiles * self.split

    @property
    def atomic(self) -> bool:
        """Whether partial sums add into a zeroed output."""
        return self.split > self.cluster


def plan(M: int, K: int, N: int, saturate: bool = False) -> Plan:
    """Tile and split-K for (M, K) x (K, N).

    CTAs of 8 warps, or 4 where 8-warp tiles split at every slab would
    still leave fewer than ``TARGET_CTAS`` CTAs.  K splits, in whole slabs
    of TILE_K (steps of K_STEP below one slab), never empty, aim at
    ``TARGET_CTAS`` CTAs and add by atomicAdd.  A saturating product
    takes at most CLUSTER_MAX splits, reduced in one cluster, so that only
    the whole sum saturates.  Raises where the grid cannot hold the
    shape."""
    if min(M, K, N) < 0 or max(M, K, N) > INT_MAX:
        raise ValueError(f"q115_matmul: M={M}, K={K}, N={N} out of range")
    n_tiles = -(-N // TILE_N)
    unit = K_STEP if K < TILE_K else TILE_K
    units = -(-K // unit)
    big = -(-M // (ROWS_PER_WARP * 8)) * n_tiles * max(1, units)
    warps = 8 if big >= TARGET_CTAS else 4
    m_tiles = -(-M // (ROWS_PER_WARP * warps))
    if m_tiles > GRID_YZ_MAX:
        raise ValueError(f"q115_matmul: M={M} exceeds the grid")
    if units == 0:
        return Plan(warps, m_tiles, n_tiles, 1, K_STEP, 1)
    want = -(-TARGET_CTAS // max(1, m_tiles * n_tiles))
    if saturate:
        want = min(want, CLUSTER_MAX)
    split = max(1, min(units, want))
    per = -(-units // split) * unit
    split = -(-K // per)
    return Plan(warps, m_tiles, n_tiles, split, per, split if saturate else 1)


def q115_matmul(x_q: Tensor, w_q: Tensor, *, saturate: bool = True) -> Tensor:
    """int16 (M, K) x int16 (K, N) -> int16 (M, N), or int32 when
    ``saturate`` is False."""
    if not x_q.is_cuda:
        if saturate:
            return q115_matmul_ref(x_q, w_q)
        return q115_matmul_acc_ref(x_q, w_q)
    _check("q115_matmul", x_q, w_q, torch.int16, torch.int16)
    dev = x_q.device
    if w_q.device != dev:
        raise ValueError("q115_matmul: every tensor must be on the device of x_q")
    M, K = x_q.shape
    N = w_q.shape[1]
    geo = plan(M, K, N, saturate)
    if saturate:
        out = torch.empty((M, N), dtype=torch.int16, device=dev)
    else:
        alloc = torch.zeros if geo.atomic else torch.empty
        out = alloc((M, N), dtype=torch.int32, device=dev)

    from repro_torch.kernels import _build

    launch = _build.load("q115_matmul")
    rc = launch(
        x_q.contiguous().data_ptr(), w_q.contiguous().data_ptr(),
        out.data_ptr(), M, K, N, geo.warps, geo.k_per_split, int(saturate),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"q115_matmul kernel launch failed: CUDA error {rc}")
    q115_matmul.launches += 1
    return out


q115_matmul.launches = 0  # kernel launches since the last reset


def q115_matmul_acc_ref(x_q: Tensor, w_q: Tensor) -> Tensor:
    """Plain PyTorch version of ``q115_matmul(..., saturate=False)`` on any
    device: every product rounded and shifted, summed over K in slices
    (CUDA has no integer ``matmul``), wrapped to int32."""
    _check("q115_matmul", x_q, w_q, torch.int16, torch.int16)
    M, K = x_q.shape
    N = w_q.shape[1]
    x, w = x_q.to(torch.int32), w_q.to(torch.int32)
    acc = torch.zeros((M, N), dtype=torch.int64, device=x_q.device)
    step = k_chunk(M, N)
    for k0 in range(0, K, step):
        prod = x[:, k0:k0 + step, None] * w[None, k0:k0 + step, :]
        acc += ((prod + _ROUND) >> FRAC_BITS).sum(1)
    return acc.to(torch.int32)


def q115_matmul_ref(x_q: Tensor, w_q: Tensor) -> Tensor:
    """Plain PyTorch version of ``q115_matmul``: the int32 sum saturated
    to int16."""
    acc = q115_matmul_acc_ref(x_q, w_q)
    return torch.clamp(acc, -(2**15), 2**15 - 1).to(torch.int16)
