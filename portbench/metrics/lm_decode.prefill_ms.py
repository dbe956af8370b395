"""Mean device ms of the LM serving engine's prefill
(``ServeEngine._prefill_body``, a CUDA graph replay): from its
``prefill_begin`` marker kernel's start to its ``prefill_end`` marker's
end, over the pairs in the traced window."""

from portbench import phases


def read(ctx):
    return phases.mean_ms(ctx.get("trace"), "prefill")
