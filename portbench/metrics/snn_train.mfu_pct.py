"""The SNN training window's share of the card's float32 peak (%): the
operations of its steps (``bounds.snn_train_flops``: the event-driven
forward and the dense backward products at the trainer's shapes) over the
window and 67 TFLOP/s."""


def read(ctx):
    c, t = ctx.get("train"), ctx.get("trace")
    if not c or "aer_bytes_per_step" not in c or not t or t["busy_s"] <= 0:
        return None
    return (c["flops_per_step"] * c["steps"] / ctx["window_s"]
            / c["peak_flops"] * 100)
