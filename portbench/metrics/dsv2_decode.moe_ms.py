"""Device ms a DeepSeek-V2 decode step spends in its expert layers (routed
and shared experts): the ``moe_begin``/``moe_end`` marker pairs that
``models/moe.py``'s dropless layer launches inside each ``decode`` pair,
summed over the layers, over the decode pairs of the traced window."""

from portbench import inner_phases


def read(ctx):
    return inner_phases.per_outer_ms(ctx.get("trace"), "moe", "decode")
