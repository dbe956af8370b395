"""Share of the traced LM serving window in which no operation ran on the
card (%)."""

from portbench import harness


def read(ctx):
    return harness.idle_pct(ctx.get("trace"))
