"""The busiest held expert's routed (token, expert) pairs over the held
experts' mean, across the window (prefills and decode steps): the
program's per-expert counter, summed on the card inside the graphs and
read after the window through ``obs.metrics``.  1 is an even load."""


def read(ctx):
    pairs = (ctx.get("dsv2_decode") or {}).get("expert_pairs")
    if not pairs or sum(pairs) <= 0:
        return None
    return max(pairs) / (sum(pairs) / len(pairs))
