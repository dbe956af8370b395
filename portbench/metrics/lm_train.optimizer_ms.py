"""Mean device ms of the LM training step's update phase (``train/loop.py``
``make_step_parts``: the norms, the clip and AdamW's leaf-by-leaf update
and apply, inside the step's graph): from its ``update_begin`` marker
kernel's start to its ``update_end`` marker's end, over the pairs in the
traced window."""

from portbench import phases


def read(ctx):
    return phases.mean_ms(ctx.get("trace"), "update")
