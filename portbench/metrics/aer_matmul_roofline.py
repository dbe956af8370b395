"""The AER gather kernel's share of its roofline (%): the least time the
window's steps need for their layer-0 and layer-1 products' bytes at
3.35 TB/s (``bounds.aer_gather_bytes`` a step: the W0 rows the first
judged batch touches, each once a step, its events and the trainer's
hidden-event counter) over the device time of every ``aer_*`` kernel in
the trace."""

from portbench import harness
from portbench.frozen import bounds


def read(ctx):
    c = ctx.get("train")
    k = harness.kernel_stats(ctx.get("trace"), "aer_")
    if not c or "aer_bytes_per_step" not in c or k is None:
        return None
    _, seconds = k
    return (c["aer_bytes_per_step"] * c["steps"] / bounds.HBM_BYTES_PER_S
            / seconds * 100)
