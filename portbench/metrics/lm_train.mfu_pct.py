"""The LM training window's share of the card's bfloat16 peak (%): the
model operations of its steps from the published shapes (forward
products and causal attention, times 3; recompute not counted) over the
window and 989 TFLOP/s."""


def read(ctx):
    c, t = ctx.get("train"), ctx.get("trace")
    if not c or not t or t["busy_s"] <= 0:
        return None
    return (c["flops_per_step"] * c["steps"] / ctx["window_s"]
            / c["peak_flops"] * 100)
