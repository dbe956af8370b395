"""Binarized CNN baseline (paper Table 2 comparator, Nakahara et al. [36]).

A small BCNN with sign-binarized weights and activations and
straight-through gradients, trained on the same collision data as the
SNN, so the energy comparison (``core.energy.bcnn_inference_ops``) and the
accuracy comparison share one dataset.

Architecture (64x64 input): conv3x3(16) -> maxpool2 -> conv3x3(32) ->
maxpool2 -> conv3x3(64) -> global-avg-pool -> dense(2).  The first conv
takes the real-valued image; later convs take binarized activations.

Layouts: images are (B, H, W) as in the reference; inside, activations
are NCHW and conv weights OIHW (``F.conv2d``), where the reference keeps
NHWC / HWIO.  ``params_from_numpy`` carries the reference's HWIO weights
across.  The convolutions and pools are library calls, as the reference
leaves them to XLA; on the card a float32 convolution runs in TF32 unless
``torch.backends.cudnn.allow_tf32`` is off, so a comparison with the CPU
turns it off.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class BCNNConfig:
    input_hw: int = 64
    channels: Tuple[int, ...] = (16, 32, 64)
    n_classes: int = 2


class _Binarize(torch.autograd.Function):
    """sign(x) in {-1, +1} (0 maps to +1) with the straight-through,
    hardtanh-clipped gradient ``g * (|x| <= 1)``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * (x.abs() <= 1.0).to(g.dtype)


def binarize(x: torch.Tensor) -> torch.Tensor:
    return _Binarize.apply(x)


def init_params(
    generator: torch.Generator, cfg: BCNNConfig, device=None
) -> Params:
    """Normal conv weights (OIHW) scaled by 1/sqrt(fan_in), unit scales,
    zero biases; drawn on the generator's device, then moved to
    ``device``."""
    gdev = generator.device

    def normal(shape, fan_in):
        w = torch.randn(shape, generator=generator, device=gdev)
        return (w / math.sqrt(fan_in)).to(device)

    params: Params = {}
    c_in = 1
    for i, c_out in enumerate(cfg.channels):
        params[f"conv{i}"] = {
            "w": normal((c_out, c_in, 3, 3), 9 * c_in),
            "g": torch.ones((c_out,), device=device),  # bn-like scale
            "b": torch.zeros((c_out,), device=device),
        }
        c_in = c_out
    params["fc"] = {
        "w": normal((c_in, cfg.n_classes), c_in),
        "b": torch.zeros((cfg.n_classes,), device=device),
    }
    return params


def params_from_numpy(
    params_np: Mapping[str, Mapping[str, np.ndarray]], device
) -> Params:
    """The reference's parameters as numpy arrays -> the port's float32
    tensors on ``device``: conv weights HWIO -> OIHW, the rest as is."""
    out: Params = {}
    for name, lp in params_np.items():
        out[name] = {}
        for k, v in lp.items():
            a = np.array(v, np.float32)
            if name.startswith("conv") and k == "w":
                a = a.transpose(3, 2, 0, 1)  # HWIO -> OIHW
            out[name][k] = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return out


def conv_block(params: Params, x: torch.Tensor, i: int) -> torch.Tensor:
    """Block i on its NCHW input (the centered image for block 0, the
    previous block's pre-sign output after it): binarized 3x3 conv
    (padding 1, the reference's SAME), scale and bias.  Returns the
    pre-sign, pre-pool activation."""
    lp = params[f"conv{i}"]
    xin = x if i == 0 else binarize(x)
    y = F.conv2d(xin, binarize(lp["w"]), padding=1)
    return y * lp["g"][:, None, None] + lp["b"][:, None, None]


def forward_layers(
    params: Params, images: torch.Tensor, cfg: BCNNConfig
) -> List[torch.Tensor]:
    """Every block's pre-sign activation (NCHW, after its pool where it
    has one) and, last, the logits (B, n_classes)."""
    x = (images * 2.0 - 1.0)[:, None]  # (B, 1, H, W), centered
    outs = []
    n_conv = len(cfg.channels)
    for i in range(n_conv):
        x = conv_block(params, x, i)
        if i < n_conv - 1:
            x = F.max_pool2d(x, 2)
        outs.append(x)
    pooled = x.mean(dim=(2, 3))  # global average pool
    outs.append(pooled @ binarize(params["fc"]["w"]) + params["fc"]["b"])
    return outs


def forward(params: Params, images: torch.Tensor, cfg: BCNNConfig) -> torch.Tensor:
    """images: (B, H, W) grayscale in [0, 1] -> logits (B, n_classes)."""
    return forward_layers(params, images, cfg)[-1]


def loss_fn(
    params: Params, images: torch.Tensor, labels: torch.Tensor, cfg: BCNNConfig
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean cross-entropy and accuracy."""
    logits = forward(params, images, cfg)
    logp = torch.log_softmax(logits, dim=-1)
    onehot = F.one_hot(labels.long(), cfg.n_classes).to(logp.dtype)
    loss = -torch.mean(torch.sum(onehot * logp, dim=-1))
    acc = torch.mean((logits.argmax(-1) == labels).to(torch.float32))
    return loss, {"accuracy": acc}


def conv_shapes_for_energy(cfg: BCNNConfig):
    """Layer shapes for ``core.energy.bcnn_inference_ops``: per conv
    (out_h, out_w, k, k, c_in, c_out), per dense layer (fan_in, fan_out)."""
    hw = cfg.input_hw
    shapes = []
    c_in = 1
    for i, c_out in enumerate(cfg.channels):
        shapes.append((hw, hw, 3, 3, c_in, c_out))
        if i < len(cfg.channels) - 1:
            hw //= 2
        c_in = c_out
    fc = [(c_in, cfg.n_classes)]
    return shapes, fc
