"""Spike x weight integration, the paper's cascaded adder (Fig. 5).

``spike_matmul`` multiplies int8 spikes (M, K) by int16 Q1.15 codes
(K, N) into an int32 (M, N) accumulator:

    out[m, n] = sum_k spikes[m, k] * weights_q[k, n]

as the reference's ``repro.kernels.ref.spike_matmul_ref`` does (an
integer product: a spike other than 0 or 1 multiplies).  On a CUDA tensor
it launches the hand-written Hopper kernel ``csrc/spike_matmul.cu``
(built at first use; int8 tensor cores, the weight split into two int8
halves) or raises; on a CPU tensor it runs ``spike_matmul_ref``, the
plain PyTorch version.  Integer sums wrap as int32 in any order, so the
two agree bit for bit.  ``plan`` is the kernel's launch geometry.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

Tensor = torch.Tensor
# the kernel's tile (csrc/spike_matmul.cu: SMM_BM, SMM_BN, SMM_BK) and
# the CTAs it aims to keep in flight: one per SM of an H100
TILE_M, TILE_N, TILE_K = 128, 64, 64
SMS = 132
GRID_YZ_MAX = 65535
# elements of the (M, k-chunk, N) int32 product a plain version holds at
# once: 128 MiB, so the (200, 4096) x (4096, 512) product runs in slices
CHUNK_ELEMS = 2**25


def _check(name: str, x: Tensor, w: Tensor, x_dtype, w_dtype) -> None:
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(
            f"{name}: need (M, K) x (K, N), got {tuple(x.shape)} x {tuple(w.shape)}"
        )
    if x.dtype != x_dtype or w.dtype != w_dtype:
        raise TypeError(
            f"{name}: need {x_dtype} x {w_dtype}, got {x.dtype} x {w.dtype}"
        )


def k_chunk(M: int, N: int) -> int:
    """Depth of the K slices a plain integer product takes at once."""
    return max(1, CHUNK_ELEMS // max(1, M * N))


@dataclass(frozen=True)
class Plan:
    """Launch geometry of one ``spike_matmul`` call."""

    m_tiles: int
    n_tiles: int
    slabs: int  # K slabs of TILE_K
    split: int  # CTAs along K (split-K); > 1 adds partial tiles atomically
    slabs_per_split: int

    @property
    def ctas(self) -> int:
        return self.m_tiles * self.n_tiles * self.split


def plan(M: int, K: int, N: int) -> Plan:
    """Tiles and split-K for (M, K) x (K, N): enough K splits that the
    grid holds about ``SMS`` CTAs, never an empty split; raises where the
    grid cannot hold the shape."""
    if min(M, K, N) < 0 or max(M, K, N) > 2**31 - 1:
        raise ValueError(f"spike_matmul: M={M}, K={K}, N={N} out of range")
    m_tiles, n_tiles = -(-M // TILE_M), -(-N // TILE_N)
    if m_tiles > GRID_YZ_MAX:
        raise ValueError(f"spike_matmul: M={M} exceeds the grid")
    slabs = -(-K // TILE_K)
    split = max(1, min(slabs, SMS // max(1, m_tiles * n_tiles)))
    per = -(-slabs // split) if slabs else 0
    split = -(-slabs // per) if slabs else 1
    return Plan(m_tiles, n_tiles, slabs, split, per)


def spike_matmul(spikes: Tensor, weights_q: Tensor) -> Tensor:
    """int8 (M, K) x int16 (K, N) -> int32 (M, N); dequantize with /2^15."""
    if not spikes.is_cuda:
        return spike_matmul_ref(spikes, weights_q)
    _check("spike_matmul", spikes, weights_q, torch.int8, torch.int16)
    dev = spikes.device
    if weights_q.device != dev:
        raise ValueError("spike_matmul: every tensor must be on the device of spikes")
    M, K = spikes.shape
    N = weights_q.shape[1]
    geo = plan(M, K, N)
    alloc = torch.zeros if geo.split > 1 else torch.empty
    out = alloc((M, N), dtype=torch.int32, device=dev)

    from repro_torch.kernels import _build

    launch = _build.load("spike_matmul")
    rc = launch(
        spikes.contiguous().data_ptr(), weights_q.contiguous().data_ptr(),
        out.data_ptr(), M, K, N, geo.split,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"spike_matmul kernel launch failed: CUDA error {rc}")
    spike_matmul.launches += 1
    return out


spike_matmul.launches = 0  # kernel launches since the last reset


def spike_matmul_ref(spikes: Tensor, weights_q: Tensor) -> Tensor:
    """Plain PyTorch version of ``spike_matmul`` on any device.  CUDA has
    no integer ``matmul``, so it sums broadcast int32 products over K in
    slices, in int64, and wraps the total to int32."""
    _check("spike_matmul", spikes, weights_q, torch.int8, torch.int16)
    M, K = spikes.shape
    N = weights_q.shape[1]
    s, w = spikes.to(torch.int32), weights_q.to(torch.int32)
    acc = torch.zeros((M, N), dtype=torch.int64, device=spikes.device)
    step = k_chunk(M, N)
    for k0 in range(0, K, step):
        acc += (s[:, k0:k0 + step, None] * w[None, k0:k0 + step, :]).sum(1)
    return acc.to(torch.int32)
