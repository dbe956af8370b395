"""Host time a serving tick spends in ``_tick`` (ms): the engine's exact
sums of ``engine.tick.host_prep_s``, ``dispatch_s`` and
``stats_fetch_s`` over the window, over its ticks."""


def read(ctx):
    c = ctx.get("snn_serve")
    if not c:
        return None
    h = c["hist"]
    ticks = h["engine.tick.host_prep_s"]["count"]
    if ticks <= 0:
        return None
    total = sum(h[k]["sum"] for k in ("engine.tick.host_prep_s",
                                      "engine.tick.dispatch_s",
                                      "engine.tick.stats_fetch_s"))
    return total / ticks * 1e3
