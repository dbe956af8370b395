"""Fused multi-step LIF dynamics: one launch for a whole coding window.

``lif_fused`` runs T steps of LIF dynamics from zero state over (T, B, N)
currents and returns the spikes (T, B, N) and the final membrane (B, N),
both float32.  ``lif_fused_from_acc`` is the same on the hardware path's
currents given as the adder tree's int32 sums and the int32 Q1.15 bias
codes, ``float32(acc + bias) / 2^15``, computed inside the same kernel.
On a CUDA tensor each launches the hand-written Hopper kernel
``csrc/lif_fused.cu`` (built at first use) or raises; on a CPU tensor it
runs its plain PyTorch version (``lif_fused_ref``,
``lif_fused_from_acc_ref``), whose separately rounded multiply and add
the kernel repeats, so on the card the two agree value for value.
``lif_fused.launches`` counts the launches of both forms.

Semantics are those of the reference's ``repro.kernels.ref.lif_fused_ref``
(hard threshold, optional refractory countdown, reset to zero or by
subtraction).  An unknown ``reset`` raises in both versions; the
reference's Pallas kernel treats it as subtraction.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import quant

Tensor = torch.Tensor
RESETS = ("zero", "subtract")
THREADS = 32  # neurons a CTA, one thread each (csrc/lif_fused.cu: LIF_THREADS)


def _check(currents: Tensor, beta: Tensor, threshold: Tensor,
           refractory_steps: int, reset: str) -> None:
    if reset not in RESETS:
        raise ValueError(f"unknown reset mechanism {reset!r}")
    if refractory_steps < 0:
        raise ValueError(f"refractory_steps must be >= 0, got {refractory_steps}")
    if currents.dim() != 3:
        raise ValueError(f"currents must be (T, B, N), got {tuple(currents.shape)}")
    N = currents.shape[2]
    for name, x in (("beta", beta), ("threshold", threshold)):
        if tuple(x.shape) != (N,):
            raise ValueError(f"{name} must be ({N},), got {tuple(x.shape)}")


def _launch(inputs: Tensor, bias: Optional[Tensor], beta: Tensor,
            threshold: Tensor, refractory_steps: int,
            reset: str) -> Tuple[Tensor, Tensor]:
    dev = inputs.device
    tensors = [("beta", beta, torch.float32), ("threshold", threshold, torch.float32)]
    if bias is not None:
        tensors.append(("bias", bias, torch.int32))
    for name, x, dtype in tensors:
        if x.device != dev:
            raise ValueError("lif_fused: every tensor must be on the device of "
                             "the currents")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    T, B, N = inputs.shape
    if T > 2**31 - 1 or N > 2**31 - 1:
        raise ValueError(f"lif_fused: T={T}, N={N} exceed the kernel's int range")
    inputs = inputs.contiguous()
    spikes = torch.empty((T, B, N), dtype=torch.float32, device=dev)
    u_fin = torch.empty((B, N), dtype=torch.float32, device=dev)

    from repro_torch.kernels import _build

    launch = _build.load("lif_fused")
    rc = launch(
        inputs.data_ptr(), None if bias is None else bias.contiguous().data_ptr(),
        beta.contiguous().data_ptr(), threshold.contiguous().data_ptr(),
        spikes.data_ptr(), u_fin.data_ptr(), T, B, N, refractory_steps,
        int(reset == "subtract"), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"lif_fused kernel launch failed: CUDA error {rc}")
    lif_fused.launches += 1
    return spikes, u_fin


def lif_fused(
    currents: Tensor,  # (T, B, N) f32
    beta: Tensor,  # (N,) f32 decay
    threshold: Tensor,  # (N,) f32
    *,
    refractory_steps: int = 0,
    reset: str = "zero",
) -> Tuple[Tensor, Tensor]:
    """Returns (spikes (T, B, N) f32, final u (B, N) f32)."""
    if not currents.is_cuda:
        return lif_fused_ref(currents, beta, threshold,
                             refractory_steps=refractory_steps, reset=reset)
    _check(currents, beta, threshold, refractory_steps, reset)
    if currents.dtype != torch.float32:
        raise TypeError(f"currents must be float32, got {currents.dtype}")
    return _launch(currents, None, beta, threshold, refractory_steps, reset)


lif_fused.launches = 0  # kernel launches of both forms since the last reset


def lif_fused_from_acc(
    acc: Tensor,  # (T, B, N) int32 adder-tree sums
    bias_q: Tensor,  # (N,) int32 Q1.15 bias codes
    beta: Tensor,  # (N,) f32 decay
    threshold: Tensor,  # (N,) f32
    *,
    refractory_steps: int = 0,
    reset: str = "zero",
) -> Tuple[Tensor, Tensor]:
    """``lif_fused`` on the currents ``float32(acc + bias_q) / 2^15`` (the
    int32 add wraps), without materialising them."""
    if not acc.is_cuda:
        return lif_fused_from_acc_ref(acc, bias_q, beta, threshold,
                                      refractory_steps=refractory_steps,
                                      reset=reset)
    _check(acc, beta, threshold, refractory_steps, reset)
    if acc.dtype != torch.int32:
        raise TypeError(f"acc must be int32, got {acc.dtype}")
    if tuple(bias_q.shape) != (acc.shape[2],):
        raise ValueError(f"bias_q must be ({acc.shape[2]},), got "
                         f"{tuple(bias_q.shape)}")
    return _launch(acc, bias_q, beta, threshold, refractory_steps, reset)


def lif_fused_from_acc_ref(
    acc: Tensor,
    bias_q: Tensor,
    beta: Tensor,
    threshold: Tensor,
    *,
    refractory_steps: int = 0,
    reset: str = "zero",
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of ``lif_fused_from_acc`` on any device: the
    int32 bias add, the conversion to float32 (nearest even; |acc| may
    exceed 2^24) and the exact divide by 2^15, then ``lif_fused_ref``."""
    currents = (acc + bias_q[None, None, :]).to(torch.float32) / quant.Q1_15.scale
    return lif_fused_ref(currents, beta, threshold,
                         refractory_steps=refractory_steps, reset=reset)


def lif_fused_ref(
    currents: Tensor,
    beta: Tensor,
    threshold: Tensor,
    *,
    refractory_steps: int = 0,
    reset: str = "zero",
) -> Tuple[Tensor, Tensor]:
    """Plain PyTorch version of ``lif_fused`` on any device: the
    reference's scan written as a loop over T."""
    _check(currents, beta, threshold, refractory_steps, reset)
    T, B, N = currents.shape
    beta, thr = beta[None, :], threshold[None, :]
    u = torch.zeros((B, N), dtype=torch.float32, device=currents.device)
    refrac = torch.zeros((B, N), dtype=torch.int32, device=currents.device)
    spikes = []
    for cur_t in currents:
        u_pre = beta * u + cur_t
        spk = (u_pre >= thr).to(torch.float32)
        if refractory_steps > 0:
            spk = spk * (refrac <= 0).to(torch.float32)
            refrac = torch.where(
                spk > 0, torch.full_like(refrac, refractory_steps),
                torch.clamp(refrac - 1, min=0),
            )
        u = u_pre * (1.0 - spk) if reset == "zero" else u_pre - thr * spk
        spikes.append(spk)
    if not spikes:
        return currents.new_zeros((0, B, N), dtype=torch.float32), u
    return torch.stack(spikes), u
