"""Spike x weight integration, the paper's cascaded adder (Fig. 5).

``spike_matmul`` multiplies int8 spikes (M, K) by int16 Q1.15 codes
(K, N) into an int32 (M, N) accumulator:

    out[m, n] = sum_k spikes[m, k] * weights_q[k, n]

as the reference's ``repro.kernels.ref.spike_matmul_ref`` does (an
integer product: a spike other than 0 or 1 multiplies).  On a CUDA tensor
it launches the hand-written Hopper kernel ``csrc/spike_matmul.cu``
(built at first use) or raises; on a CPU tensor it runs
``spike_matmul_ref``, the plain PyTorch version.  Integer sums wrap as
int32 in any order, so the two agree bit for bit.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor
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
    if -(-M // 16) > 65535 or max(M, K, N) > 2**31 - 1:
        raise ValueError(f"spike_matmul: M={M}, K={K}, N={N} exceed the grid")
    out = torch.empty((M, N), dtype=torch.int32, device=dev)

    from repro_torch.kernels import _build

    launch = _build.load("spike_matmul")
    rc = launch(
        spikes.contiguous().data_ptr(), weights_q.contiguous().data_ptr(),
        out.data_ptr(), M, K, N, torch.cuda.current_stream(dev).cuda_stream,
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
