"""Event-driven synaptic integration: one launch per event table.

``aer_spike_matmul_batched`` computes

    out[b, n] = sum_e values[b, e] * weights[addrs[b, e], n]

for B streams of E events each, and ``aer_spike_matmul`` the same for one
stream, ``out[n]``, in int32 (the reference's single-stream kernel, run
here on the batched kernel with B = 1).  On a CUDA tensor it launches the
hand-written Hopper kernel ``csrc/aer_matmul.cu`` (built at first use) or
raises; on a CPU tensor it runs ``aer_spike_matmul_batched_ref``, the
plain PyTorch version, which adds one event at a time in the kernel's
order, so on the card the two agree value for value.

Contracts, those of the reference's ``repro.kernels.aer_matmul``:

- int16 weights with integer values (int8/int16/int32) accumulate in
  int32, bit-exact against ``aer_spike_matmul_ref`` per stream;
- float32 weights with float32 values accumulate in float32 (the
  surrogate-gradient training forward).

An event whose value is 0 (padding) or whose address lies outside
[0, K) contributes nothing, and no row outside [0, K) is ever read.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor
_INT_VALUES = (torch.int8, torch.int16, torch.int32)


def _check(addrs: Tensor, values: Tensor, weights: Tensor) -> None:
    if addrs.dim() != 2:
        raise ValueError(f"addrs must be (B, E), got {tuple(addrs.shape)}")
    if values.shape != addrs.shape:
        raise ValueError(
            f"values {tuple(values.shape)} != addrs {tuple(addrs.shape)}"
        )
    if weights.dim() != 2 or weights.shape[0] < 1:
        raise ValueError(f"weights must be (K >= 1, N), got {tuple(weights.shape)}")
    if addrs.dtype != torch.int32:
        raise TypeError(f"addrs must be int32, got {addrs.dtype}")
    if weights.dtype == torch.int16:
        if values.dtype not in _INT_VALUES:
            raise TypeError(
                f"int16 weights take int8/int16/int32 values, got {values.dtype}"
            )
    elif weights.dtype == torch.float32:
        if values.dtype != torch.float32:
            raise TypeError(f"float32 weights take float32 values, got {values.dtype}")
    else:
        raise TypeError(f"weights must be int16 or float32, got {weights.dtype}")


def aer_spike_matmul_batched(
    addrs: Tensor,  # (B, E) int32 event addresses
    values: Tensor,  # (B, E) signed event values, 0 on padding
    weights: Tensor,  # (K, N) int16 Q1.15 codes or float32 weights
) -> Tensor:
    """(B, N) int32 for int16 weights, float32 for float32 weights."""
    if not addrs.is_cuda:
        return aer_spike_matmul_batched_ref(addrs, values, weights)
    out = _launch(addrs, values, weights)
    aer_spike_matmul_batched.launches += 1
    return out


aer_spike_matmul_batched.launches = 0  # kernel launches since the last reset


def _launch(addrs: Tensor, values: Tensor, weights: Tensor) -> Tensor:
    """Launch ``csrc/aer_matmul.cu`` on (B, E) tables; counts nothing."""
    _check(addrs, values, weights)
    dev = addrs.device
    if values.device != dev or weights.device != dev:
        raise ValueError(
            "aer_spike_matmul_batched: every tensor must be on the device of addrs"
        )
    B, E = addrs.shape
    K, N = weights.shape
    if B > 2**31 - 1 or E > 2**31 - 1 or -(-N // 128) > 65535:
        raise ValueError(
            f"aer_spike_matmul_batched: B={B}, E={E}, N={N} exceed the grid"
        )
    int16 = weights.dtype == torch.int16
    acc = torch.int32 if int16 else torch.float32
    addrs = addrs.contiguous()
    values = values.to(acc).contiguous()
    weights = weights.contiguous()
    out = torch.empty((B, N), dtype=acc, device=dev)

    from repro_torch.kernels import _build

    launch = _build.load("aer_matmul")
    rc = launch(
        addrs.data_ptr(), values.data_ptr(), weights.data_ptr(),
        out.data_ptr(), B, E, K, N, int(int16),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"aer_matmul kernel launch failed: CUDA error {rc}")
    return out


def aer_spike_matmul_batched_ref(
    addrs: Tensor, values: Tensor, weights: Tensor
) -> Tensor:
    """Plain PyTorch version of ``aer_spike_matmul_batched`` on any device.

    Repeats the kernel's arithmetic: for e ascending, every stream adds
    ``values[b, e] * weights[addrs[b, e]]`` where the event is live
    (nonzero value, address in [0, K)), each product and sum rounded
    separately (int32 wraps).  Reads the number of events to walk back to
    the host, so it synchronises with the device.
    """
    _check(addrs, values, weights)
    K, N = weights.shape
    if weights.dtype == torch.int16:
        w, v = weights.to(torch.int32), values.to(torch.int32)
    else:
        w, v = weights, values
    a = addrs.long()
    live = (v != 0) & (a >= 0) & (a < K)
    a = torch.where(live, a, 0)
    acc = torch.zeros((addrs.shape[0], N), dtype=w.dtype, device=w.device)
    idx = torch.arange(1, addrs.shape[1] + 1, device=addrs.device)
    n_walk = int((live * idx).max()) if live.numel() else 0
    for e in range(n_walk):
        term = v[:, e : e + 1] * w[a[:, e]]
        acc = torch.where(live[:, e : e + 1], acc + term, acc)
    return acc


def _check_single(addrs: Tensor, values: Tensor, weights_q: Tensor) -> None:
    if addrs.dim() != 1 or values.shape != addrs.shape:
        raise ValueError(
            f"addrs and values must be (E,), got {tuple(addrs.shape)} and "
            f"{tuple(values.shape)}"
        )
    if weights_q.dim() != 2 or weights_q.shape[0] < 1:
        raise ValueError(f"weights_q must be (K >= 1, N), got {tuple(weights_q.shape)}")
    if addrs.dtype != torch.int32:
        raise TypeError(f"addrs must be int32, got {addrs.dtype}")
    if values.dtype not in _INT_VALUES + (torch.int64,):
        raise TypeError(f"values must be an integer type, got {values.dtype}")
    if weights_q.dtype != torch.int16:
        raise TypeError(f"weights_q must be int16, got {weights_q.dtype}")


def aer_spike_matmul(
    addrs: Tensor,  # (E,) int32 event addresses in [0, K)
    values: Tensor,  # (E,) integer event values, 0 on padding
    weights_q: Tensor,  # (K, N) int16 Q1.15 codes
) -> Tensor:
    """(N,) int32: ``sum_e values[e] * weights_q[addrs[e], n]``, the
    values cast to int32 first as the reference does.  Dequantize with
    /2^15."""
    if not addrs.is_cuda:
        return aer_spike_matmul_ref(addrs, values, weights_q)
    _check_single(addrs, values, weights_q)
    out = _launch(addrs[None], values.to(torch.int32)[None], weights_q)
    aer_spike_matmul.launches += 1
    return out[0]


aer_spike_matmul.launches = 0  # kernel launches since the last reset


def aer_spike_matmul_ref(
    addrs: Tensor, values: Tensor, weights_q: Tensor
) -> Tensor:
    """Plain PyTorch version of ``aer_spike_matmul`` on any device: the
    live events' rows gathered, weighted and summed in int64, wrapped to
    int32 (integer sums agree in any order).  A live event has a nonzero
    value and an address in [0, K), as in the kernel; the reference
    leaves an out-of-range address on a live event undefined."""
    _check_single(addrs, values, weights_q)
    K = weights_q.shape[0]
    v = values.to(torch.int32)
    a = addrs.long()
    live = (v != 0) & (a >= 0) & (a < K)
    rows = weights_q[torch.where(live, a, 0)].to(torch.int64)
    v = torch.where(live, v, 0).to(torch.int64)
    return (rows * v[:, None]).sum(0).to(torch.int32)
