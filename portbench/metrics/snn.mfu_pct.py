"""The served window's share of the card's float32 peak (%): the
operations the window's answered inputs need (``bounds.snn_forward_flops``:
2 a layer-0 event and column, 2 a hidden spike and column, the LIF
updates) over the window and 67 TFLOP/s."""

from portbench.frozen import bounds


def read(ctx):
    c, t = ctx.get("snn_serve"), ctx.get("trace")
    if not c or not t or t["busy_s"] <= 0 or c["flops"] <= 0:
        return None
    return c["flops"] / ctx["window_s"] / bounds.F32_FLOPS * 100
