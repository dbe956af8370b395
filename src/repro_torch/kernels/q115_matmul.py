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
kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.spike_matmul import _check, k_chunk

Tensor = torch.Tensor
FRAC_BITS = 15
_ROUND = 1 << (FRAC_BITS - 1)


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
    if -(-M // 16) > 65535 or max(M, K, N) > 2**31 - 1:
        raise ValueError(f"q115_matmul: M={M}, K={K}, N={N} exceed the grid")
    out = torch.empty((M, N), dtype=torch.int16 if saturate else torch.int32,
                      device=dev)

    from repro_torch.kernels import _build

    launch = _build.load("q115_matmul")
    rc = launch(
        x_q.contiguous().data_ptr(), w_q.contiguous().data_ptr(),
        out.data_ptr(), M, K, N, int(saturate),
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
