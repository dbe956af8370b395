"""Fixed-point quantization (paper §4.3: Q1.15 weights/biases/state).

``quantize``/``dequantize`` give integer codes; ``fake_quant`` rounds a
float tensor to the Q-grid with a straight-through gradient.  Both round
half to even (``torch.round``), as the reference does, so codes and
fake-quantized values are bit-exact against it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import tree_map


@dataclasses.dataclass(frozen=True)
class QFormat:
    """Signed fixed-point format with ``int_bits`` integer (incl. sign) and
    ``frac_bits`` fractional bits."""

    int_bits: int = 1
    frac_bits: int = 15

    @property
    def total_bits(self) -> int:
        return self.int_bits + self.frac_bits

    @property
    def scale(self) -> float:
        return float(2**self.frac_bits)

    @property
    def max_val(self) -> float:
        return (2 ** (self.total_bits - 1) - 1) / self.scale

    @property
    def min_val(self) -> float:
        return -(2 ** (self.total_bits - 1)) / self.scale

    @property
    def storage_dtype(self) -> torch.dtype:
        if self.total_bits <= 8:
            return torch.int8
        if self.total_bits <= 16:
            return torch.int16
        return torch.int32


Q1_15 = QFormat(1, 15)
Q4_12 = QFormat(4, 12)
Q8_8 = QFormat(8, 8)
Q1_7 = QFormat(1, 7)


def quantize(x: torch.Tensor, fmt: QFormat = Q1_15) -> torch.Tensor:
    """Float -> integer codes (round-to-nearest-even, saturating)."""
    lo = -(2 ** (fmt.total_bits - 1))
    hi = 2 ** (fmt.total_bits - 1) - 1
    codes = torch.clamp(torch.round(x * fmt.scale), lo, hi)
    return codes.to(fmt.storage_dtype)


def dequantize(codes: torch.Tensor, fmt: QFormat = Q1_15) -> torch.Tensor:
    return codes.to(torch.float32) / fmt.scale


class _STERound(torch.autograd.Function):
    """Round in the forward pass, identity gradient in the backward."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def fake_quant(x: torch.Tensor, fmt: QFormat = Q1_15) -> torch.Tensor:
    """Round ``x`` to the Q-grid, straight-through gradient (QAT hook).

    Bit-exact match of quantize->dequantize for in-range values.  The clip
    is a maximum then a minimum, not ``torch.clamp``: at an input exactly
    on a bound the gradient splits 0.5/0.5 between ``x`` and the bound,
    as the reference's ``jnp.clip`` does (``torch.clamp`` passes it whole).
    """
    # filled on the device: a host copy could not run inside a CUDA graph
    lo = torch.full((), fmt.min_val, dtype=x.dtype, device=x.device)
    hi = torch.full((), fmt.max_val, dtype=x.dtype, device=x.device)
    clipped = torch.minimum(torch.maximum(x, lo), hi)
    return _STERound.apply(clipped * fmt.scale) / fmt.scale


def quant_params(params, fmt: QFormat = Q1_15):
    """Fake-quantize every float leaf of a params tree (Q1.15 mode)."""

    def leaf(x):
        if isinstance(x, torch.Tensor) and x.is_floating_point():
            return fake_quant(x, fmt)
        return x

    return tree_map(leaf, params)


def accumulator_bits(fan_in: int, fmt: QFormat = Q1_15) -> int:
    """Bits needed to hold a fan_in-wide sum of Q-format values without
    overflow: the paper's '28-bit intermediate result' for its adder tree.

    A sum of ``fan_in`` Q1.15 values needs 16 + ceil(log2(fan_in)) bits;
    e.g. fan_in=4096 -> 16+12 = 28 bits, exactly the paper's width.
    """
    return fmt.total_bits + max(1, math.ceil(math.log2(max(fan_in, 2))))
