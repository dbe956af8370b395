"""Device time of a program phase, read from its marker kernels in a
traced window.

The program brackets a phase's device work with two empty kernels,
``phase_marker_<phase>_begin`` and ``phase_marker_<phase>_end``, launched
on the phase's stream (inside its CUDA graph where it is captured).  A
phase's device time is from its begin marker's start to its end marker's
end.  A marker whose partner lies outside the window is left out; a
program without markers gives no pairs.
"""

from __future__ import annotations

from typing import Dict, List, Optional

PREFIX = "phase_marker_"


def durations_ns(trace: Optional[Dict], phase: str) -> List[int]:
    """Each begin-end pair's device ns of ``phase``, in launch order."""
    if not trace:
        return []
    begin, end = f"{PREFIX}{phase}_begin", f"{PREFIX}{phase}_end"
    marks = sorted((start, begin in name, dur)
                   for name, start, dur in trace["kernels"]
                   if begin in name or end in name)
    out, opened = [], None
    for start, is_begin, dur in marks:
        if is_begin:
            opened = start
        elif opened is not None:
            out.append(start + dur - opened)
            opened = None
    return out


def mean_ms(trace: Optional[Dict], phase: str) -> Optional[float]:
    """Mean device ms of ``phase`` over its pairs; None without any."""
    d = durations_ns(trace, phase)
    return sum(d) / len(d) / 1e6 if d else None
