"""How a training cell's first steps are judged against the reference
that follows them from the same weights and batches.

A leaf's gap is the gap between the program's value and the
reference's, over the reference's value or the median leaf's, whichever
is larger (some gradients are all but zero).  The loss is taken by the
worst step (``loss_gap``) and at the first step alone
(``first_loss_gap``: a spiking network's later losses carry each spike
that the steps before flipped, so it is the steady one there); the first
gradient by the worst leaf.  The change after the steps is taken by the
median leaf: a leaf can hold elements whose
gradient is nought to rounding (the key bias's dims that the rotary
embedding leaves alone shift every score of a query alike, which the
softmax cancels), which Adam moves by round-off alone, so its worst
leaf reads the rounding of the side that computed it (``worst_change``
is printed beside it).  Leaves whose whole reference gradient at step 1
is under a thousandth of the median leaf's are left out of the change,
by that rule and not by name.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict

TINY_GRADIENT = 1e-3


def leaf_gaps(a: Dict, b: Dict, names) -> Dict[str, float]:
    med = statistics.median(b[n] for n in names)
    return {n: abs(a[n] - b[n]) / max(b[n], med) if max(b[n], med) > 0
            else (0.0 if a[n] == b[n] else math.inf) for n in names}


def readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    """``prog`` and ``ref`` hold ``loss`` (a list a step), ``grad`` (each
    leaf's gradient norm as the optimizer got it at step 1) and
    ``change`` (each leaf's change after the steps); ``ref`` also
    ``grad_raw``.  Returns loss_gap, first_loss_gap, grad_norm_gap,
    change_gap and worst_change (the worst leaf's gap in the change, told
    beside the median's)."""
    gaps = [abs(a - b) / abs(b) if b else math.inf
            for a, b in zip(prog["loss"], ref["loss"])]
    if any(not math.isfinite(x) for x in prog["loss"]):
        gaps = [math.inf] * len(gaps)
    names = sorted(ref["grad"])
    med_raw = statistics.median(ref["grad_raw"].values())
    moving = [n for n in names if ref["grad_raw"][n] >= TINY_GRADIENT * med_raw]
    change = leaf_gaps(prog["change"], ref["change"], moving)
    return {"loss_gap": float(max(gaps)), "first_loss_gap": float(gaps[0]),
            "grad_norm_gap": float(max(leaf_gaps(prog["grad"], ref["grad"],
                                                 names).values())),
            "change_gap": float(statistics.median(change.values())),
            "worst_change": float(max(change.values()))}


def excluded(ref: Dict):
    """The leaves the change leaves out (their reference gradient)."""
    med_raw = statistics.median(ref["grad_raw"].values())
    return {n: g for n, g in ref["grad_raw"].items()
            if g < TINY_GRADIENT * med_raw}
