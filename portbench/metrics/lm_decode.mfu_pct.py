"""The LM serving window's share of the card's bfloat16 peak (%): the
operations of its batches from the published shapes (the prompt's
products and causal attention, then each decoded token's products and
its attention over the positions before it) over the window and
989 TFLOP/s."""


def read(ctx):
    c, t = ctx.get("lm_decode"), ctx.get("trace")
    if not c or not t or t["busy_s"] <= 0:
        return None
    return (c["flops_per_batch"] * c["batches"] / ctx["window_s"]
            / c["peak_flops"] * 100)
