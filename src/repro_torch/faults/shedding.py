"""Admission-plane load shedding for the SNN stream engine.

The paper's case study — collision avoidance — is deadline-driven: a
result that arrives after its deadline is worthless, and an engine that
*accepts* work it provably cannot finish on time spends capacity
manufacturing guaranteed misses.  This module is the admission plane's
decision logic, split into two pure, unit-testable checks the engine
calls at its two admission boundaries:

- :func:`backpressure` at ``submit()`` — a bounded admission queue.
  When the queue is at ``max_queue_depth`` the request is **shed**
  immediately (``priority > 0`` requests are **parked** instead, up to
  the same bound), so overload surfaces as an explicit ``SHED``
  disposition at the edge rather than as unbounded queue growth and a
  tail of deadline misses.

- :func:`feasibility` at admission-pop time — the EDF-aware shedder.
  When a queued request wins a free slot, its deadline is tested
  against a **provable lower bound** on its completion time derived
  from the measured trailing-window tick rate
  (``obs.timeseries.rate("engine.tick.dispatch_s.count")``): a slot
  advances at most ``Tc`` steps per tick, so a ``T``-step window takes
  at least ``T / (ticks_per_s * Tc)`` seconds from now.  If even that
  optimistic bound lands past the deadline, the request is shed (or
  parked for ``priority > 0``) — the engine refuses to convert a
  certain miss into wasted chunks.  With no measured rate (cold engine,
  empty window) the check **abstains and admits**: "provably
  unmeetable" requires evidence, and shedding on a guess would turn the
  admission plane itself into a fault.

Both checks return a :class:`Verdict` (``admit`` / ``shed`` / ``park``)
plus a reason string that flows into ``StreamResult.fault`` and the
``engine.requests.shed`` / ``engine.requests.parked`` counters, so the
SLO machinery can tell "breaching because overloaded and shedding
correctly" from "breaching because broken" (see
``SNNStreamEngine.health()``'s diagnosis block).

The port's copy of ``repro.faults.shedding``, value for value.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

__all__ = ["AdmissionPolicy", "Verdict", "backpressure", "feasibility"]

ADMIT = "admit"
SHED = "shed"
PARK = "park"

Verdict = Tuple[str, Optional[str]]  # (ADMIT|SHED|PARK, reason)


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Knobs of the admission plane.

    ``max_queue_depth``
        Bounded admission queue; ``None`` keeps the historical
        unbounded queue (no backpressure shedding).
    ``shed_unmeetable``
        Enable the feasibility shedder at admission-pop time.
    ``rate_window_s``
        Trailing window the measured tick rate is read over; the check
        falls back to the whole-series rate when the window saw no
        flow (an engine idle for longer than the window).
    ``safety``
        Multiplier on the completion-time lower bound.  1.0 sheds only
        on the provable bound; > 1.0 sheds earlier (pessimistic), < 1.0
        is not meaningful and is clamped to 1.0.
    ``min_ticks_per_s``
        Minimum measured rate that counts as evidence; below it the
        feasibility check abstains (admits).
    """

    max_queue_depth: Optional[int] = None
    shed_unmeetable: bool = True
    rate_window_s: float = 2.0
    safety: float = 1.0
    min_ticks_per_s: float = 1e-3

    def __post_init__(self):
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError(
                f"max_queue_depth must be >= 1 or None, got "
                f"{self.max_queue_depth}"
            )
        if self.rate_window_s <= 0:
            raise ValueError("rate_window_s must be > 0")


def backpressure(
    policy: AdmissionPolicy,
    *,
    queue_depth: int,
    parked_depth: int,
    priority: int,
) -> Verdict:
    """Bounded-queue check at ``submit()``.

    Sheds once the queue is full; ``priority > 0`` requests park instead
    (best-effort service once the queue drains), but the parked list is
    bounded by the same depth so a priority flood cannot reopen the
    unbounded-queue failure mode.
    """
    if policy.max_queue_depth is None:
        return ADMIT, None
    if queue_depth < policy.max_queue_depth:
        return ADMIT, None
    if priority > 0 and parked_depth < policy.max_queue_depth:
        return PARK, "queue_full"
    return SHED, "queue_full"


def eta_lower_bound_s(
    *, steps: int, ticks_per_s: float, chunk_steps: int
) -> float:
    """Provable lower bound on serving ``steps`` from a standing start:
    a slot advances at most ``chunk_steps`` per tick, ticks arrive at
    the measured rate, so completion takes at least this many seconds.
    """
    ticks_needed = -(-int(steps) // int(chunk_steps))  # ceil division
    return ticks_needed / ticks_per_s


def feasibility(
    policy: AdmissionPolicy,
    *,
    steps: int,
    chunk_steps: int,
    deadline_abs: Optional[float],
    now: float,
    ticks_per_s: float,
    priority: int,
) -> Verdict:
    """EDF-aware shed check when a queued request wins a free slot.

    ``ticks_per_s`` is the measured trailing-window tick rate (the
    caller reads it off the engine's ``TimeSeriesSampler``); 0 or
    sub-threshold rates mean "no evidence" and the check admits.
    """
    if not policy.shed_unmeetable or deadline_abs is None:
        return ADMIT, None
    if ticks_per_s < policy.min_ticks_per_s:
        return ADMIT, None  # no measured evidence: cannot *prove* a miss
    eta = now + max(policy.safety, 1.0) * eta_lower_bound_s(
        steps=steps, ticks_per_s=ticks_per_s, chunk_steps=chunk_steps
    )
    if eta <= deadline_abs:
        return ADMIT, None
    if priority > 0:
        return PARK, "deadline_unmeetable"
    return SHED, "deadline_unmeetable"
