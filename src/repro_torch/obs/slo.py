"""Declarative SLOs with multi-window burn-rate evaluation.

An SLO pairs an *objective* ("99% of requests meet their deadline",
"p99 latency under 500 ms") with an *error budget* (the tolerated
failure fraction) and is judged by its **burn rate**: the ratio of the
observed windowed error rate to the budgeted rate.  Burn rate 1.0 means
the budget is being consumed exactly at the sustainable pace; 10x means
it will be gone in a tenth of the period.

Evaluation follows the multi-window pattern (Google SRE workbook ch. 5):
each :class:`BurnRateRule` fires only when the burn rate exceeds its
threshold over **both** a long window (evidence the problem is real, not
a blip) and a short window (evidence it is *still* happening — the rule
un-fires quickly once the incident ends).  Rules carry a severity; the
worst severity across fired rules, across SLOs, is the overall verdict:

    ``healthy``  — no rule fired
    ``degraded`` — a warn-severity rule fired (slow burn)
    ``breach``   — a page-severity rule fired (fast burn)

Two spec kinds cover the serving engine's needs:

- :class:`ErrorBudgetSLO` — a good/total counter pair (deadline misses
  over completions).  Windowed error rate = delta(errors)/delta(total)
  from the :class:`~repro_torch.obs.timeseries.TimeSeriesSampler`.
- :class:`LatencySLO` — a percentile target over a histogram the
  sampler tracks buckets for.  The objective "p99 <= target" is
  evaluated as its error-budget equivalent — at most (100-p)% of
  requests may exceed the target — with the windowed fraction-over-
  target read exactly (at bucket granularity) from the windowed
  histogram reconstruction.

Windows are clipped to the data the series actually holds (a 5 s window
over a 2 s bench run reads the whole run, flagged ``clipped``); a rule
with *no* flow in its window abstains rather than firing.

``evaluate()`` returns a JSON-able report; ``SNNStreamEngine.health()``
runs it over the engine's own sampler and publishes the verdict as the
``engine.slo.status`` gauge (0/1/2).  A copy of the reference's jax-free
``repro.obs.slo`` over the port's ``obs.timeseries``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.obs.timeseries import TimeSeriesSampler

__all__ = [
    "BurnRateRule",
    "ErrorBudgetSLO",
    "LatencySLO",
    "STATUS_CODES",
    "default_slos",
    "evaluate",
    "shed_rate_slo",
    "status_of",
]

# gauge encoding of the verdict (engine.slo.status)
STATUS_CODES = {"healthy": 0, "degraded": 1, "breach": 2}
_SEVERITIES = ("degraded", "breach")


@dataclasses.dataclass(frozen=True)
class BurnRateRule:
    """Fire ``severity`` when burn rate > ``threshold`` over both
    windows.  Classic pairs: (long=1h, short=5m, 14.4x, page) and
    (long=6h, short=30m, 6x, warn) for a 30-day budget; serving-bench
    scale uses seconds — the semantics are window-size agnostic."""

    long_window_s: float
    short_window_s: float
    threshold: float  # x budget
    severity: str = "breach"

    def __post_init__(self):
        if self.severity not in _SEVERITIES:
            raise ValueError(
                f"severity {self.severity!r} not in {_SEVERITIES}"
            )
        if not (0 < self.short_window_s <= self.long_window_s):
            raise ValueError(
                "need 0 < short_window_s <= long_window_s "
                f"({self.short_window_s}, {self.long_window_s})"
            )
        if self.threshold <= 0:
            raise ValueError("burn threshold must be > 0")


@dataclasses.dataclass(frozen=True)
class ErrorBudgetSLO:
    """Objective: at least ``objective`` of ``total_key`` flow is *not*
    counted by ``error_key``.  Budget = 1 - objective."""

    name: str
    error_key: str  # counter (or histogram .count) delta key
    total_key: str
    objective: float  # e.g. 0.95 -> 5% error budget
    rules: Tuple[BurnRateRule, ...]

    def __post_init__(self):
        if not (0.0 < self.objective < 1.0):
            raise ValueError(f"objective must be in (0, 1): {self.objective}")

    @property
    def budget(self) -> float:
        return 1.0 - self.objective

    def error_rate(
        self, series: TimeSeriesSampler, window_s: Optional[float]
    ) -> Tuple[Optional[float], float]:
        """(windowed error fraction or None when no flow, total flow)."""
        total = series.window_sum(self.total_key, window_s)
        if total <= 0:
            return None, 0.0
        return series.window_sum(self.error_key, window_s) / total, total


@dataclasses.dataclass(frozen=True)
class LatencySLO:
    """Objective: the ``percentile``-th percentile of ``histogram_key``
    stays <= ``target_s`` — evaluated as the equivalent error budget
    (at most (100-percentile)% of requests over target)."""

    name: str
    histogram_key: str  # must be in the sampler's track_buckets
    target_s: float
    percentile: float = 99.0
    rules: Tuple[BurnRateRule, ...] = ()

    def __post_init__(self):
        if not (0.0 < self.percentile < 100.0):
            raise ValueError("percentile must be in (0, 100)")
        if self.target_s <= 0:
            raise ValueError("target_s must be > 0")

    @property
    def budget(self) -> float:
        return (100.0 - self.percentile) / 100.0

    def error_rate(
        self, series: TimeSeriesSampler, window_s: Optional[float]
    ) -> Tuple[Optional[float], float]:
        """Windowed fraction of recorded values above ``target_s``,
        from the bucket-diff reconstruction (exact at bucket
        granularity: a bucket counts as "over" when its lower edge is
        >= target, "under" when its upper edge is <= target, and the
        straddling bucket splits geometrically)."""
        h = series.windowed_histogram(self.histogram_key, window_s)
        if h is None or h.count == 0:
            return None, 0.0
        over = float(h._overflow)
        target = self.target_s
        for i, c in enumerate(h._counts):
            if not c:
                continue
            lower = h.lo if i == 0 else h._edges[i - 1]
            upper = h._edges[i]
            if lower >= target:
                over += c
            elif upper > target:
                # geometric split of the straddling bucket
                frac_under = (
                    math.log(target / lower) / math.log(upper / lower)
                )
                over += c * (1.0 - frac_under)
        return over / h.count, float(h.count)


SLOSpec = Union[ErrorBudgetSLO, LatencySLO]


def default_slos(
    *,
    deadline_objective: float = 0.95,
    p99_target_s: float = 1.0,
    scale_s: float = 1.0,
) -> Tuple[SLOSpec, ...]:
    """The serving engine's standard SLO pair.

    ``scale_s`` stretches the rule windows (1.0 = bench scale: 2 s/0.5 s
    fast-burn page, 8 s/2 s slow-burn warn; a long-lived fleet would
    pass minutes-to-hours scale).
    """
    rules = (
        BurnRateRule(
            long_window_s=2.0 * scale_s,
            short_window_s=0.5 * scale_s,
            threshold=10.0,
            severity="breach",
        ),
        BurnRateRule(
            long_window_s=8.0 * scale_s,
            short_window_s=2.0 * scale_s,
            threshold=2.0,
            severity="degraded",
        ),
    )
    return (
        ErrorBudgetSLO(
            name="deadline_misses",
            error_key="engine.requests.deadline_missed",
            total_key="engine.requests.completed",
            objective=deadline_objective,
            rules=rules,
        ),
        LatencySLO(
            name="latency_p99",
            histogram_key="engine.request.latency_s",
            target_s=p99_target_s,
            percentile=99.0,
            rules=rules,
        ),
    )


def shed_rate_slo(
    *,
    objective: float = 0.99,
    scale_s: float = 1.0,
) -> ErrorBudgetSLO:
    """Opt-in fault-tolerance SLO: at least ``objective`` of submitted
    requests are *not* shed by the admission plane.

    Deliberately not part of :func:`default_slos` — with shedding off
    (the engine default) the counter never moves and the rule only
    abstains, and an engine that sheds under overload is *degrading
    correctly* (``engine.health()['diagnosis']`` reads it as
    ``overloaded``, not broken).  Operators running a bounded queue
    append this to the default pair to page on sustained shedding:

    ``slos=default_slos(...) + (shed_rate_slo(objective=0.95),)``
    """
    return ErrorBudgetSLO(
        name="shed_rate",
        error_key="engine.requests.shed",
        total_key="engine.requests.submitted",
        objective=objective,
        rules=(
            BurnRateRule(
                long_window_s=2.0 * scale_s,
                short_window_s=0.5 * scale_s,
                threshold=10.0,
                severity="breach",
            ),
            BurnRateRule(
                long_window_s=8.0 * scale_s,
                short_window_s=2.0 * scale_s,
                threshold=2.0,
                severity="degraded",
            ),
        ),
    )


def _eval_rule(
    slo: SLOSpec, rule: BurnRateRule, series: TimeSeriesSampler
) -> Dict:
    span = series.span_s()
    out: Dict = {
        "severity": rule.severity,
        "threshold": rule.threshold,
        "long_window_s": rule.long_window_s,
        "short_window_s": rule.short_window_s,
        "clipped": span < rule.long_window_s,
        "fired": False,
    }
    burns = {}
    for label, window_s in (
        ("long", rule.long_window_s),
        ("short", rule.short_window_s),
    ):
        err, flow = slo.error_rate(series, window_s)
        burns[label] = (
            None if err is None else err / slo.budget
        )
        out[f"{label}_error_rate"] = err
        out[f"{label}_burn_rate"] = burns[label]
        out[f"{label}_flow"] = flow
    # both windows must show the burn; a window with no flow abstains
    out["fired"] = all(
        b is not None and b > rule.threshold for b in burns.values()
    )
    return out


def evaluate(
    slos: Sequence[SLOSpec], series: TimeSeriesSampler
) -> Dict:
    """Evaluate every SLO's rules against the series; returns a
    JSON-able report with the overall ``status`` verdict."""
    report_slos: List[Dict] = []
    worst = 0
    for slo in slos:
        err_all, flow_all = slo.error_rate(series, None)
        rules = [_eval_rule(slo, r, series) for r in slo.rules]
        slo_worst = 0
        for r in rules:
            if r["fired"]:
                slo_worst = max(
                    slo_worst, STATUS_CODES[r["severity"]]
                )
        worst = max(worst, slo_worst)
        entry = {
            "name": slo.name,
            "kind": type(slo).__name__,
            "budget": slo.budget,
            "observed_error_rate": err_all,
            "observed_flow": flow_all,
            "status": status_of(slo_worst),
            "rules": rules,
        }
        if isinstance(slo, LatencySLO):
            entry["target_s"] = slo.target_s
            entry["percentile"] = slo.percentile
        report_slos.append(entry)
    return {
        "status": status_of(worst),
        "status_code": worst,
        "span_s": series.span_s(),
        "samples": len(series),
        "slos": report_slos,
    }


def status_of(code: int) -> str:
    for name, c in STATUS_CODES.items():
        if c == code:
            return name
    raise ValueError(f"unknown status code {code}")
