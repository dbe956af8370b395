"""Public kernel API, the counterpart of the reference's
``repro.kernels.ops``.

Every kernel wrapper is re-exported as it is: the tensor's device picks
the path (a CUDA tensor launches the hand-written kernel or raises, a CPU
tensor runs the plain version), so there is no ``on_tpu()`` and no
``interpret``.  Also hosts the composed op of the inference path,
``snn_layer_forward``: spike_matmul -> bias -> lif_fused, the paper's
Fig. 5 pipeline (cascaded adder -> LIF neuron hardware unit), as two
kernels: the LIF kernel takes the adder tree's int32 sums and adds the
bias itself (``lif_fused_from_acc``).
"""

from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.kernels.aer_matmul import (
    aer_spike_matmul,
    aer_spike_matmul_batched,
)
from repro_torch.kernels.lif_fused import lif_fused, lif_fused_from_acc
from repro_torch.kernels.q115_matmul import q115_matmul
from repro_torch.kernels.snn_chunk import snn_chunk
from repro_torch.kernels.spike_matmul import spike_matmul

__all__ = [
    "aer_spike_matmul",
    "aer_spike_matmul_batched",
    "lif_fused",
    "lif_fused_from_acc",
    "q115_matmul",
    "snn_chunk",
    "snn_layer_forward",
    "spike_matmul",
]

Tensor = torch.Tensor


def snn_layer_forward(
    spikes_T: Tensor,  # (T, B, fan_in) f32/int {0,1} input spike train
    w: Tensor,  # (fan_in, fan_out) float weights
    b: Tensor,  # (fan_out,) float bias
    beta: Tensor,  # (fan_out,)
    threshold: Tensor,  # (fan_out,)
    *,
    refractory_steps: int = 0,
) -> Tensor:
    """Full hardware-path layer: Q1.15 weights, integer cascaded-adder
    integration of every step, fused LIF over the window.  Returns the
    spike train (T, B, fan_out) f32; two kernel launches on the card.

    This is the inference path of paper Fig. 5; training uses the float
    graph in core/snn.py (QAT via quant.fake_quant keeps them aligned).
    """
    T, B, fan_in = spikes_T.shape
    wq = quant.quantize(w, quant.Q1_15)  # (fan_in, fan_out) int16
    # bias in the same Q1.15 scale, as int32 codes
    bq = quant.quantize(b, quant.Q1_15).to(torch.int32)

    # integrate all T steps: fold time into rows for one big integration
    spk_i8 = spikes_T.reshape(T * B, fan_in).to(torch.int8)
    acc = spike_matmul(spk_i8, wq)  # (T*B, fan_out) int32
    # the LIF kernel adds the bias post-adder-tree in the same fixed-point
    # scale (paper §4.3; int32 wrap), converts int32 -> f32 to nearest even
    # and divides exactly by 2^15, as the reference does in three ops
    # (|acc| may exceed 2^24)
    out_spikes, _ = lif_fused_from_acc(
        acc.reshape(T, B, -1), bq, beta, threshold,
        refractory_steps=refractory_steps,
    )
    return out_spikes
