"""The paper's LIF network (§3.1 Eq. 2, §4.2, Fig. 4) in plain PyTorch.

Dense products over the input planes, the first-order LIF with its reset
to zero (the reset's membrane factor carries no gradient), the Heaviside
spike with the arctan surrogate (alpha 2) in the backward, dropout on the
hidden spikes, the membrane cross-entropy summed over steps and averaged
over the batch, global-norm clipping and bias-corrected Adam.  Params are
``{"layer{i}": {"w" (fan_in, fan_out), "b", "beta_raw", "threshold"}}``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

Params = Dict[str, Dict[str, torch.Tensor]]
ALPHA = 2.0


class _Spike(torch.autograd.Function):
    @staticmethod
    def forward(ctx, v):
        ctx.save_for_backward(v)
        return (v >= 0).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        return g * (ALPHA / (2.0 * (1.0 + (math.pi / 2.0 * ALPHA * v) ** 2)))


def init_params(gen: torch.Generator, sizes, beta: float, threshold: float,
                device) -> Params:
    """Kaiming-uniform layers, ``beta`` through its logit, from ``gen``
    (on ``device``): the benchmark's own weights, drawn from the seed."""
    params = {}
    raw = math.log(beta / (1.0 - beta))
    for i, (k, n) in enumerate(zip(sizes[:-1], sizes[1:])):
        bound = 1.0 / math.sqrt(k)
        w = torch.rand((k, n), generator=gen, device=device) * 2.0 - 1.0
        b = torch.rand((n,), generator=gen, device=device) * 2.0 - 1.0
        params[f"layer{i}"] = {
            "w": w * bound, "b": b * bound,
            "beta_raw": torch.full((n,), raw, device=device),
            "threshold": torch.full((n,), float(threshold), device=device),
        }
    return params


F32_UNIT = 2.0 ** -24  # float32's unit roundoff


def forward(params: Params, planes: torch.Tensor, *,
            dropout_u: Optional[torch.Tensor] = None, rate: float = 0.0,
            flips: Optional[Dict[Tuple[int, int], torch.Tensor]] = None,
            margins: Optional[List] = None
            ) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """Planes (T, B, K) -> (output membranes (T, B, C), output spikes
    (T, B, C), per-layer input events [(B,) each]).  With ``dropout_u``
    (T, B, hidden) the hidden spikes are dropped where ``u >= 1 - rate``
    and the kept ones scaled by ``1 / (1 - rate)``.  ``flips`` {(t, layer):
    (B, N) 0/1} puts those neurons on the other side of their threshold
    (the surrogate gradient unchanged).  ``margins``, a list, receives
    (t, layer, pre - threshold, rounding) for every step and layer, where
    ``rounding`` is the scale of a float32 sum's error in ``pre`` in any
    order: the unit roundoff times the events' count times the rms of
    their terms, plus the leak and bias terms."""
    layers = [params[f"layer{i}"] for i in range(len(params))]
    B = planes.shape[1]
    u = [torch.zeros((B, lp["w"].shape[1]), device=planes.device)
         for lp in layers]
    events = [torch.zeros((B,), device=planes.device) for _ in layers]
    mems, spks = [], []
    for t in range(planes.shape[0]):
        h = planes[t]
        for i, lp in enumerate(layers):
            n = (h.detach() != 0).sum(-1).float()
            events[i] = events[i] + n
            leak = torch.sigmoid(lp["beta_raw"]) * u[i]
            pre = leak + h @ lp["w"] + lp["b"]
            s = _Spike.apply(pre - lp["threshold"])
            if flips is not None and (t, i) in flips:
                s = s + (1.0 - 2.0 * s.detach()) * flips[(t, i)]
            if margins is not None:
                with torch.no_grad():
                    sq = (h * h) @ (lp["w"] * lp["w"])
                    rounding = F32_UNIT * (torch.sqrt(n[:, None] * sq)
                                           + leak.abs() + lp["b"].abs())
                    margins.append((t, i, (pre - lp["threshold"]).detach(),
                                    rounding))
            u[i] = pre - pre.detach() * s
            h = s
            if i == 0 and dropout_u is not None and rate > 0.0:
                h = s * (dropout_u[t] < 1.0 - rate).to(s.dtype) / (1.0 - rate)
        mems.append(u[-1])
        spks.append(h)
    return torch.stack(mems), torch.stack(spks), events


def serve_readout(params: Params, planes: torch.Tensor, block: int = 64
                  ) -> Dict[str, torch.Tensor]:
    """What a served window answers, per recording of ``planes`` (R, T, K),
    in blocks of ``block`` recordings: output spike counts (R, C), the
    prediction (R,) (the count argmax, ties broken by the summed output
    membranes), hidden spikes (R,) and input events (R,)."""
    outs = {"counts": [], "prediction": [], "hidden": [], "inputs": []}
    with torch.no_grad():
        for r0 in range(0, planes.shape[0], block):
            x = planes[r0:r0 + block].transpose(0, 1)
            mem, spk, ev = forward(params, x)
            counts = spk.sum(0)
            outs["counts"].append(counts)
            outs["prediction"].append(
                torch.argmax(counts + 1e-6 * mem.sum(0), -1))
            outs["inputs"].append(ev[0])
            outs["hidden"].append(ev[1])
    return {k: torch.cat(v) for k, v in outs.items()}


def membrane_ce(out_mem: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(out_mem, dim=-1)
    nll = -torch.gather(logp, -1, labels.long()[None, :, None].expand(
        out_mem.shape[0], -1, 1))[..., 0]
    return nll.sum(0).mean()


def clipped_grads(params: Params, planes: torch.Tensor,
                  labels: torch.Tensor, *, clip: float, dropout_u=None,
                  rate: float = 0.0, flips=None, margins=None):
    """Surrogate BPTT's gradients after global-norm clipping, as the
    optimizer gets them: (loss, {(layer, key): gradient}, each layer's
    input events a recording).  ``flips`` and ``margins`` as for
    ``forward``."""
    names = [(ln, k) for ln in sorted(params) for k in sorted(params[ln])]
    leaves = [params[ln][k].detach().requires_grad_(True) for ln, k in names]
    live = {}
    for (ln, k), x in zip(names, leaves):
        live.setdefault(ln, {})[k] = x
    with torch.enable_grad():
        mem, _, events = forward(live, planes, dropout_u=dropout_u, rate=rate,
                                 flips=flips, margins=margins)
        loss = membrane_ce(mem, labels)
        grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        scale = torch.clamp(clip / (norm + 1e-9), max=1.0)
        clipped = {n: g * scale for n, g in zip(names, grads)}
    return loss.detach(), clipped, [float(e.mean()) for e in events]


def train_step(params: Params, opt: Dict, planes: torch.Tensor,
               labels: torch.Tensor, *, lr: float, clip: float,
               dropout_u=None, rate: float = 0.0, b1: float = 0.9,
               b2: float = 0.999, eps: float = 1e-8, margins=None):
    """One step of surrogate BPTT, global-norm clip and Adam, in place on
    ``params`` and ``opt`` ({"count", "mu", "nu"}, keyed as the params).
    Returns (loss, the clipped gradients, each layer's input events a
    recording)."""
    loss, clipped, events = clipped_grads(
        params, planes, labels, clip=clip, dropout_u=dropout_u, rate=rate,
        margins=margins)
    with torch.no_grad():
        opt["count"] += 1
        c1 = 1 - b1 ** opt["count"]
        c2 = 1 - b2 ** opt["count"]
        for (ln, k), g in clipped.items():
            m = opt["mu"][ln][k] = b1 * opt["mu"][ln][k] + (1 - b1) * g
            v = opt["nu"][ln][k] = b2 * opt["nu"][ln][k] + (1 - b2) * g * g
            params[ln][k] = params[ln][k] - lr * (m / c1) / (
                torch.sqrt(v / c2) + eps)
    return loss, clipped, events


def adam_init(params: Params) -> Dict:
    z = {ln: {k: torch.zeros_like(v) for k, v in lp.items()}
         for ln, lp in params.items()}
    return {"count": 0, "mu": z,
            "nu": {ln: {k: torch.zeros_like(v) for k, v in lp.items()}
                   for ln, lp in params.items()}}
