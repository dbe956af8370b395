"""Device ms a DeepSeek-V2 decode step spends in its latent-attention
cores (the cache write through ``wo``): the ``mla_begin``/``mla_end``
marker pairs that ``models/attention.py``'s ``mla_decode`` launches
inside each ``decode`` pair, summed over the layers, over the decode
pairs of the traced window."""

from portbench import inner_phases


def read(ctx):
    return inner_phases.per_outer_ms(ctx.get("trace"), "mla", "decode")
