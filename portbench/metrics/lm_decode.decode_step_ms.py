"""Mean device ms of the LM serving engine's decode step
(``ServeEngine._decode_body``, a CUDA graph replay): from its
``decode_begin`` marker kernel's start to its ``decode_end`` marker's
end, over the pairs in the traced window."""

from portbench import phases


def read(ctx):
    return phases.mean_ms(ctx.get("trace"), "decode")
