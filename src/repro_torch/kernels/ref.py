"""The plain PyTorch versions of the kernels, under the reference's
``repro.kernels.ref`` names.  Each lives beside its kernel's wrapper; the
CPU path of every wrapper runs it, and the card's tests hold each kernel
against it."""

from repro_torch.kernels.aer_matmul import aer_spike_matmul_ref
from repro_torch.kernels.lif_fused import lif_fused_ref
from repro_torch.kernels.q115_matmul import q115_matmul_acc_ref, q115_matmul_ref
from repro_torch.kernels.spike_matmul import spike_matmul_ref

__all__ = [
    "aer_spike_matmul_ref",
    "lif_fused_ref",
    "q115_matmul_acc_ref",
    "q115_matmul_ref",
    "spike_matmul_ref",
]
