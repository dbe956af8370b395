"""Mean host time of one admission (ms): the engine's ``stage`` spans
(``_admit_graphed``) that started inside the window."""


def read(ctx):
    c = ctx.get("snn_serve")
    if not c or not c["stage_s"]:
        return None
    return sum(c["stage_s"]) / len(c["stage_s"]) * 1e3
