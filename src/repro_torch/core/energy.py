"""Analytic energy/operation model (paper Tables 2-3 analog).

Operations and memory accesses per inference, priced with published
per-op energies (Horowitz, ISSCC 2014, 45nm).  These are model estimates,
not measurements of any device.  The paper's claim (an event-driven,
adder-only Q1.15 SNN at 1093 GOPS/W against a binarized CNN at 143,
"86% more energy efficient") is reproduced in structure: the SNN's
measured events against the BCNN baseline's op count (``bcnn36_inference_ops``,
``core.bcnn.conv_shapes_for_energy``), priced with the same table.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence

# pJ per operation (Horowitz ISSCC'14, 45nm)
ENERGY_PJ: Dict[str, float] = {
    "add_i8": 0.03,
    "add_i16": 0.05,
    "add_i32": 0.10,
    "mul_i8": 0.20,
    "mul_i16": 0.80,
    "mul_i32": 3.10,
    "add_f16": 0.40,
    "mul_f16": 1.10,
    "add_f32": 0.90,
    "mul_f32": 3.70,
    "cmp_i16": 0.03,  # comparator ~ narrow add
    "xnor_popcnt": 0.02,  # 1b xnor + popcount slice, per synapse
    "sram_64b": 5.0,
    "dram_64b": 640.0,
}


@dataclasses.dataclass
class OpCount:
    """Operation & memory-access tally for one inference."""

    ops: Dict[str, float] = dataclasses.field(default_factory=dict)

    def add(self, kind: str, n: float) -> None:
        self.ops[kind] = self.ops.get(kind, 0.0) + float(n)

    def energy_pj(self) -> float:
        return sum(ENERGY_PJ[k] * n for k, n in self.ops.items())

    def total_ops(self) -> float:
        """Arithmetic ops only (paper counts GOPS over compute ops)."""
        return sum(
            n for k, n in self.ops.items() if not k.startswith(("sram", "dram"))
        )

    def gops_per_watt(self) -> float:
        """ops / joule == GOPS/W (unit identity)."""
        e_j = self.energy_pj() * 1e-12
        if e_j == 0:
            return float("inf")
        return self.total_ops() / e_j / 1e9


def snn_inference_ops(
    layer_sizes: Sequence[int],
    num_steps: int,
    spike_rates: Sequence[float],
    *,
    weight_bits: int = 16,
    event_driven: bool = True,
) -> OpCount:
    """Event-driven SNN cost from assumed input spike rates.

    ``spike_rates[i]`` is the mean firing rate of the input to layer i.
    One int-add per active input synapse per step; one int16 mul + add +
    compare per neuron per step.
    """
    c = OpCount()
    acc_add = "add_i32"  # 28-bit intermediate -> int32 accumulator class
    for i, (fan_in, fan_out) in enumerate(zip(layer_sizes[:-1], layer_sizes[1:])):
        rate = spike_rates[i] if event_driven else 1.0
        syn_adds = num_steps * rate * fan_in * fan_out
        c.add(acc_add, syn_adds)
        c.add(acc_add, num_steps * fan_out)  # bias add
        c.add("mul_i16", num_steps * fan_out)
        c.add("add_i16", num_steps * fan_out)
        c.add("cmp_i16", num_steps * fan_out)
        wpl = 64 // weight_bits
        c.add("sram_64b", num_steps * rate * fan_in * fan_out / wpl)
    c.add("sram_64b", num_steps * layer_sizes[0] / 64)
    return c


def snn_ops_from_events(
    layer_sizes: Sequence[int],
    num_steps: int,
    events_per_layer: Sequence[float],
    *,
    weight_bits: int = 16,
    neuron_kind: str = "lif",
) -> OpCount:
    """Event-driven SNN cost from **measured** event counts.

    ``events_per_layer[i]`` is the number of input events layer i received
    over the window.  One accumulator add and one weight fetch per event
    per output; the neuron update runs every step for every neuron.
    """
    c = OpCount()
    acc_add = "add_i32"
    wpl = 64 // weight_bits
    for i, (fan_in, fan_out) in enumerate(zip(layer_sizes[:-1], layer_sizes[1:])):
        ev = float(events_per_layer[i])
        c.add(acc_add, ev * fan_out)
        c.add(acc_add, num_steps * fan_out)  # bias add
        if neuron_kind == "lif":
            c.add("mul_i16", num_steps * fan_out)  # beta * U
        c.add("add_i16", num_steps * fan_out)
        c.add("cmp_i16", num_steps * fan_out)
        c.add("sram_64b", ev * fan_out / wpl)
    # AER input events arrive as ~32-bit (time, address) words, 2 per line
    c.add("sram_64b", float(events_per_layer[0]) / 2)
    return c


def snn_train_ops_from_events(
    layer_sizes: Sequence[int],
    num_steps: int,
    events_per_layer: Sequence[float],
    *,
    dense: bool = False,
) -> OpCount:
    """Surrogate-gradient BPTT cost of one training example (fwd + bwd).

    The event-driven trainer (``sparse_train``) pays per *measured* event:

      - forward gather:      1 f32 add per event per output
      - weight-grad scatter: 1 f32 MAC per event per output (the backward
        scatters cotangents through the same active-event index set —
        dense BPTT's ``h^T @ g`` is zero at silent rows, so this is exact)
      - input cotangent ``g @ W^T``: dense (surrogate derivatives are
        nonzero off-spike), but only for hidden layers — the input layer,
        the widest one, needs no input cotangent at all
      - bias grad + neuron fwd/bwd: fixed per neuron-step

    With ``dense=True`` the same graph is priced at the dense trainer's
    cost (every synapse a MAC in forward and in the weight grad,
    regardless of activity) — the flat baseline the event path is
    compared against.
    """
    c = OpCount()
    for i, (fan_in, fan_out) in enumerate(
        zip(layer_sizes[:-1], layer_sizes[1:])
    ):
        ev = (
            float(num_steps * fan_in)
            if dense
            else float(events_per_layer[i])
        )
        if dense:
            # dense forward + weight grad are MACs over every synapse
            c.add("mul_f32", ev * fan_out)
            c.add("add_f32", ev * fan_out)
            c.add("mul_f32", ev * fan_out)
            c.add("add_f32", ev * fan_out)
        else:
            # gathered forward: binary/polarity spikes, adds only
            c.add("add_f32", ev * fan_out)
            # event-set weight-grad scatter: value * cotangent MAC
            c.add("mul_f32", ev * fan_out)
            c.add("add_f32", ev * fan_out)
        # weight fetches (fwd) + grad-row touches (bwd), f32 words
        c.add("sram_64b", 2 * ev * fan_out / 2)
        if i > 0:
            # input cotangent g @ W^T — dense support either way
            c.add("mul_f32", num_steps * fan_in * fan_out)
            c.add("add_f32", num_steps * fan_in * fan_out)
            c.add("sram_64b", num_steps * fan_in * fan_out / 2)
        # bias add (fwd) + bias grad (bwd)
        c.add("add_f32", 2 * num_steps * fan_out)
        # neuron update fwd (beta*U + I, compare) and bwd (surrogate grad
        # eval + chain through beta/threshold/membrane): ~6 f32 ops/step
        c.add("mul_f32", 3 * num_steps * fan_out)
        c.add("add_f32", 3 * num_steps * fan_out)
    return c


# Paper Table 2 (Artix-7, measured): the SNN row and its BCNN baseline.
PAPER_TABLE2 = {
    "snn": {"power_mw": 495.0, "gops": 541.0, "gops_per_w": 1093.0},
    "bcnn36": {"power_mw": 2300.0, "gops": 329.0, "gops_per_w": 143.0},
}


def gopsw_deviation(model_gopsw: float, paper_gopsw: float) -> float:
    """Signed relative deviation of the model estimate from the paper's
    measured Artix-7 GOPS/W: (model - paper) / paper."""
    return (model_gopsw - paper_gopsw) / paper_gopsw


def bcnn_inference_ops(
    conv_shapes: Sequence[tuple],
    fc_shapes: Sequence[tuple],
) -> OpCount:
    """Binarized CNN cost (paper's Table 2 baseline [36]).

    conv_shapes: (out_h, out_w, k, k, c_in, c_out) per conv layer.
    fc_shapes:   (fan_in, fan_out) per dense layer.
    Binarized MAC = XNOR+popcount per synapse; batch-norm/sign per output
    as int16 ops; activations/weights fetched from SRAM.
    """
    c = OpCount()
    for (oh, ow, k1, k2, cin, cout) in conv_shapes:
        macs = oh * ow * k1 * k2 * cin * cout
        c.add("xnor_popcnt", macs)
        c.add("add_i16", oh * ow * cout)  # bn + sign
        c.add("sram_64b", macs / 64)
    for (fi, fo) in fc_shapes:
        c.add("xnor_popcnt", fi * fo)
        c.add("add_i16", fo)
        c.add("sram_64b", fi * fo / 64)
    return c


def dense_fcn_inference_ops(
    layer_sizes: Sequence[int], *, bits: int = 16
) -> OpCount:
    """16-bit dense FCN cost — the 'traditional FCN' the paper contrasts."""
    c = OpCount()
    mul = "mul_i16" if bits == 16 else "mul_f32"
    add = "add_i32" if bits == 16 else "add_f32"
    for fan_in, fan_out in zip(layer_sizes[:-1], layer_sizes[1:]):
        c.add(mul, fan_in * fan_out)
        c.add(add, fan_in * fan_out)
        c.add("sram_64b", fan_in * fan_out / (64 // bits))
    return c


def efficiency_gain(snn: OpCount, baseline: OpCount) -> float:
    """Paper's headline metric: (SNN GOPS/W - base GOPS/W)/SNN GOPS/W.

    The paper states the SNN is '86% more energy efficient' with
    1093 vs 143 GOPS/W; (1093-143)/1093 = 0.869.
    """
    s, b = snn.gops_per_watt(), baseline.gops_per_watt()
    return (s - b) / s


def energy_reduction(snn: OpCount, baseline: OpCount) -> float:
    """Energy-per-inference reduction: 1 - E_snn / E_base.

    This is the analytically-meaningful form of the paper's 86% claim:
    the SNN solves the task with far fewer (and cheaper) operations than
    the generic CNN baseline, so its energy *per classification* is ~8x
    lower.  (GOPS/W by itself rewards cheap ops, not less work — the
    paper's measured GOPS/W gap additionally folds in platform power.)
    """
    return 1.0 - snn.energy_pj() / baseline.energy_pj()


# Published per-frame workload of the paper's BCNN baseline [36]
# (Nakahara et al., FPL'17): 329 GOPS at 161 fps -> ~2.0e9 ops/frame.
BCNN36_OPS_PER_FRAME = 329e9 / 161.0


def bcnn36_inference_ops() -> OpCount:
    """Op-count model of the paper's Table-2 BCNN baseline at its
    *published* scale, priced with the same energy table."""
    c = OpCount()
    c.add("xnor_popcnt", BCNN36_OPS_PER_FRAME)
    c.add("sram_64b", BCNN36_OPS_PER_FRAME / 64)
    return c
