"""The card's published peaks and the operation and byte counts the
roofline and mfu metrics divide by.

Peaks: NVIDIA's data sheet for one H100 SXM at its 700 W limit, dense
rates.  The byte counts follow ``chip_smoke.py``'s bounds (each input
byte read once, each output byte written once, what these inputs need and
not the most they could); the operation counts are the published
mathematics at its shapes, never what a kernel happens to recompute.
"""

from __future__ import annotations

from typing import Sequence

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12  # float32 outside the tensor cores
BF16_FLOPS = 989e12  # dense bfloat16 tensor cores


def snn_chunk_bytes(slots: int, steps: int, widths: Sequence[int],
                    events: float, w0_rows: float) -> float:
    """Bytes one launch of the serving chunk must move: the W0 rows its
    events gather (each once), the later layers' weights, bias, beta and
    threshold, its events (int16 address and int8 value each), per-step
    counts and the active mask, each slot's membrane and refractory state
    read and written, and its outputs (membranes, spikes and per-layer
    event counts of each step).  The hidden layers' weights are read
    whole, whatever their events."""
    n = list(widths[1:])
    total = sum(n)
    return float(
        w0_rows * n[0] * 4
        + sum(a * b * 4 for a, b in zip(n[:-1], n[1:]))
        + 3 * total * 4
        + events * 3
        + slots * steps * 4 + slots * 4
        + 2 * slots * total * 8
        + 2 * steps * slots * n[-1] * 4 + steps * len(n) * slots * 4)


def snn_forward_flops(widths: Sequence[int], steps: int,
                      events: Sequence[float]) -> float:
    """Float operations an event-driven forward of ``steps`` steps needs:
    a multiply and an add per input event and output column of each layer
    (``events[i]`` input events of layer ``i``), and per neuron and step
    the LIF update (a multiply, two adds and a compare)."""
    n = list(widths[1:])
    return float(sum(2 * e * w for e, w in zip(events, n))
                 + 4 * steps * sum(n))


def snn_train_flops(widths: Sequence[int], steps: int, batch: int,
                    events: Sequence[float]) -> float:
    """Float operations of one surrogate-BPTT step at the trainer's
    shapes: the event-driven forward (``events`` summed over the batch),
    then the dense backward products: for every layer the weight gradient
    (2 K N per row and step) and, past the input layer, the input
    gradient (2 K N per row and step)."""
    fwd = snn_forward_flops(widths, steps * batch, events)
    bwd = 0.0
    for i, (k, n) in enumerate(zip(widths[:-1], widths[1:])):
        bwd += 2.0 * k * n * steps * batch * (2 if i > 0 else 1)
    return fwd + bwd


def aer_gather_bytes(rows_touched: float, width: int, events: float,
                     batch_rows: int) -> float:
    """Bytes one AER gather-accumulate launch must move: the weight rows
    its events touch (each once), the events (int32 address and float
    value), and its (rows, width) float output."""
    return float(rows_touched * width * 4 + events * 8
                 + batch_rows * width * 4)


def lm_matmul_params(d_model: int, n_heads: int, n_kv: int, head_dim: int,
                     d_ff: int, n_layers: int, vocab: int,
                     gated: bool = True) -> int:
    """Weights a token multiplies through: per layer the q, k, v and o
    projections and the MLP's two (three when gated) products, then the
    LM head.  The embedding is a lookup, not a product."""
    attn = d_model * (n_heads + 2 * n_kv) * head_dim + n_heads * head_dim * d_model
    mlp = (3 if gated else 2) * d_model * d_ff
    return n_layers * (attn + mlp) + d_model * vocab


def lm_forward_flops(tokens: int, ctx_pairs: float, d_model: int,
                     n_heads: int, n_kv: int, head_dim: int, d_ff: int,
                     n_layers: int, vocab: int) -> float:
    """Forward operations: 2 per weight per token, and attention's two
    products (scores and the weighted values), 4 * head_dim per head and
    (query, key) pair the causal mask keeps (``ctx_pairs`` of them, summed
    over the batch)."""
    dense = 2.0 * tokens * lm_matmul_params(d_model, n_heads, n_kv, head_dim,
                                            d_ff, n_layers, vocab)
    return dense + 4.0 * head_dim * n_heads * n_layers * ctx_pairs


def causal_pairs(batch: int, seq: int) -> float:
    """(query, key) pairs a causal mask keeps over ``batch`` sequences."""
    return batch * seq * (seq + 1) / 2.0
