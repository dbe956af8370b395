"""Analytic energy/operation model (paper Tables 2-3 analog).

Operations and memory accesses per inference, priced with published
per-op energies (Horowitz, ISSCC 2014, 45nm).  These are model estimates,
not measurements of any device.
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
