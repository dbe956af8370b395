"""95th percentile of submit -> admission (ms), from the window's share of
the engine's ``engine.request.queue_wait_s`` histogram."""

from portbench import harness


def read(ctx):
    c = ctx.get("snn_serve")
    if not c:
        return None
    p = harness.histogram_percentile(c["hist"]["engine.request.queue_wait_s"],
                                     95)
    return None if p is None else p * 1e3
