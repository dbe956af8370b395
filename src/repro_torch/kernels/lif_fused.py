"""Fused multi-step LIF dynamics: one launch for a whole coding window.

``lif_fused`` runs T steps of LIF dynamics from zero state over (T, B, N)
currents and returns the spikes (T, B, N) and the final membrane (B, N),
both float32.  On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/lif_fused.cu`` (built at first use) or raises; on a CPU tensor it
runs ``lif_fused_ref``, the plain PyTorch version, whose separately
rounded multiply and add the kernel repeats, so on the card the two agree
value for value.

Semantics are those of the reference's ``repro.kernels.ref.lif_fused_ref``
(hard threshold, optional refractory countdown, reset to zero or by
subtraction).  An unknown ``reset`` raises in both versions; the
reference's Pallas kernel treats it as subtraction.
"""

from __future__ import annotations

from typing import Tuple

import torch

Tensor = torch.Tensor
RESETS = ("zero", "subtract")


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
    dev = currents.device
    if beta.device != dev or threshold.device != dev:
        raise ValueError("lif_fused: every tensor must be on the device of currents")
    for name, x in (("currents", currents), ("beta", beta),
                    ("threshold", threshold)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    T, B, N = currents.shape
    if T > 2**31 - 1 or N > 2**31 - 1:
        raise ValueError(f"lif_fused: T={T}, N={N} exceed the kernel's int range")
    currents = currents.contiguous()
    spikes = torch.empty((T, B, N), dtype=torch.float32, device=dev)
    u_fin = torch.empty((B, N), dtype=torch.float32, device=dev)

    from repro_torch.kernels import _build

    launch = _build.load("lif_fused")
    rc = launch(
        currents.data_ptr(), beta.contiguous().data_ptr(),
        threshold.contiguous().data_ptr(), spikes.data_ptr(),
        u_fin.data_ptr(), T, B, N, refractory_steps, int(reset == "subtract"),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"lif_fused kernel launch failed: CUDA error {rc}")
    lif_fused.launches += 1
    return spikes, u_fin


lif_fused.launches = 0  # kernel launches since the last reset


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
