"""Device time of a phase inside another, read from their marker kernels
in a traced window (``phases.py``'s pairs): the inner phase's pairs that
begin inside each outer pair, summed per outer pair."""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Tuple

from portbench.phases import PREFIX


def _pairs(trace: Dict, phase: str) -> List[Tuple[int, int]]:
    """(start, end) ns of each whole begin-end pair of ``phase``."""
    begin, end = f"{PREFIX}{phase}_begin", f"{PREFIX}{phase}_end"
    marks = sorted((start, begin in name, start + dur)
                   for name, start, dur in trace["kernels"]
                   if begin in name or end in name)
    out, opened = [], None
    for start, is_begin, stop in marks:
        if is_begin:
            opened = start
        elif opened is not None:
            out.append((opened, stop))
            opened = None
    return out


def per_outer_ms(trace: Optional[Dict], inner: str,
                 outer: str) -> Optional[float]:
    """Mean device ms of ``inner`` per ``outer`` pair: the inner pairs that
    begin inside an outer pair, summed, over the outer pairs; None where
    either phase has no pairs (a program without their markers)."""
    if not trace:
        return None
    outs, ins = _pairs(trace, outer), _pairs(trace, inner)
    if not outs or not ins:
        return None
    starts = [s for s, _ in ins]
    total = 0
    for o0, o1 in outs:
        i = bisect.bisect_left(starts, o0)
        while i < len(ins) and ins[i][0] < o1:
            total += ins[i][1] - ins[i][0]
            i += 1
    return total / len(outs) / 1e6
