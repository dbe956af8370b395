"""``snn_chunk``'s share of its roofline (%): the least time its bytes
need at 3.35 TB/s (``bounds.snn_chunk_bytes``, per launch at the window's
mean events a launch) over its mean device time in the trace."""

from portbench import harness
from portbench.frozen import bounds


def read(ctx):
    c = ctx.get("snn_serve")
    k = harness.kernel_stats(ctx.get("trace"), "snn_chunk")
    if not c or k is None:
        return None
    n, seconds = k
    return c["bytes_per_launch"] / bounds.HBM_BYTES_PER_S / (seconds / n) * 100
