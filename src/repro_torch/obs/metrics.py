"""Dependency-free metrics registry for the serving stack.

Three instrument kinds, one registry:

- ``Counter`` — monotonically increasing float (events served, steps
  dispatched, deadline misses).
- ``Gauge`` — last-write-wins scalar (queue depth, episode wall time).
- ``Histogram`` — fixed-bucket *log-scale* histogram with exact
  count/sum/min/max and approximate percentiles.  Bucket upper edges are
  geometric: ``lo * 10**(i / buckets_per_decade)``, so relative
  resolution is constant across the range — right for latencies and
  energies that span decades.  Percentile extraction walks the
  cumulative counts and interpolates *geometrically* inside the landing
  bucket, then clamps to the observed ``[min, max]``; the worst-case
  relative error is one bucket ratio (``10**(1/buckets_per_decade)``,
  ~15.5% at the default 16 buckets/decade), which the obs test suite
  pins against numpy on known distributions.

Everything is plain Python (stdlib ``math``/``bisect`` only): recording
is a few arithmetic ops and a bisect, cheap enough to leave on in a hot
loop.  Instruments are unlocked; wrap the registry externally if you
share one across threads.

Snapshots are plain JSON-able dicts (``registry.snapshot()``), the format
``launch/train.py --metrics-json`` writes.
"""

from __future__ import annotations

import bisect
import json
import math
from typing import Dict, List, Optional, Union

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """Monotonic float counter."""

    kind = "counter"

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter {self.name}: negative increment {v}")
        self._value += v

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        self._value = 0.0

    def snapshot(self) -> Dict:
        return {"type": "counter", "value": self._value}


class Gauge:
    """Last-write-wins scalar."""

    kind = "gauge"

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0

    def set(self, v: float) -> None:
        self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def reset(self) -> None:
        self._value = 0.0

    def snapshot(self) -> Dict:
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Fixed-bucket log-scale histogram with p50/p90/p99 extraction.

    Values ``<= lo`` land in the underflow bucket, values ``> hi`` (after
    rounding ``hi`` up to a whole bucket edge) in the overflow bucket;
    both are reported separately so a snapshot always accounts for every
    recorded value exactly (``underflow + overflow + sum(bucket counts)
    == count``).  Non-positive values count as underflow — log buckets
    cannot place them, but min/sum/count still track them exactly.

    Non-finite values (a diverged loss going NaN, an inf latency from a
    broken clock) are counted in a separate ``invalid`` field and kept
    out of count/sum/min/max/buckets entirely: one NaN must not poison
    ``sum``/``mean`` forever (``nan + x == nan``) or land silently in
    bucket 0 via ``bisect_left``'s NaN comparison semantics.
    """

    kind = "histogram"

    def __init__(
        self,
        name: str,
        *,
        lo: float,
        hi: float,
        buckets_per_decade: int = 16,
    ):
        if not (0 < lo < hi):
            raise ValueError(f"histogram {name}: need 0 < lo < hi")
        if buckets_per_decade < 1:
            raise ValueError(f"histogram {name}: buckets_per_decade >= 1")
        self.name = name
        self.lo = float(lo)
        self.hi = float(hi)
        self.buckets_per_decade = int(buckets_per_decade)
        n = int(math.ceil(
            round(math.log10(hi / lo), 9) * buckets_per_decade
        ))
        n = max(n, 1)
        # upper edges; edges[-1] >= hi by construction
        self._edges: List[float] = [
            lo * 10.0 ** ((i + 1) / buckets_per_decade) for i in range(n)
        ]
        self._counts = [0] * n
        self._underflow = 0
        self._overflow = 0
        self.count = 0
        self.sum = 0.0
        self.invalid = 0
        self.min = math.inf
        self.max = -math.inf

    def record(self, v: float) -> None:
        v = float(v)
        if not math.isfinite(v):
            # NaN/inf: tallied separately, kept out of every finite
            # statistic (a single NaN would otherwise poison sum/mean
            # forever and bisect into bucket 0)
            self.invalid += 1
            return
        self.count += 1
        self.sum += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        if v <= self.lo:
            self._underflow += 1
        elif v > self._edges[-1]:
            self._overflow += 1
        else:
            self._counts[bisect.bisect_left(self._edges, v)] += 1

    def reset(self) -> None:
        self._counts = [0] * len(self._counts)
        self._underflow = 0
        self._overflow = 0
        self.count = 0
        self.sum = 0.0
        self.invalid = 0
        self.min = math.inf
        self.max = -math.inf

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (nearest-rank over buckets,
        geometric interpolation inside the landing bucket, clamped to
        the observed [min, max]).  0.0 when empty."""
        if self.count == 0:
            return 0.0
        target = max(1, int(math.ceil(q / 100.0 * self.count)))
        cum = self._underflow
        if target <= cum:
            # everything below lo collapses to the exact observed min
            return self.min
        for i, c in enumerate(self._counts):
            if c == 0:
                continue
            if target <= cum + c:
                lower = self.lo if i == 0 else self._edges[i - 1]
                upper = self._edges[i]
                frac = (target - cum) / c
                est = lower * (upper / lower) ** frac
                return min(max(est, self.min), self.max)
            cum += c
        return self.max  # overflow bucket

    def snapshot(self) -> Dict:
        empty = self.count == 0
        return {
            "type": "histogram",
            "count": self.count,
            "sum": self.sum,
            "min": 0.0 if empty else self.min,
            "max": 0.0 if empty else self.max,
            "mean": self.mean,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
            "lo": self.lo,
            "hi": self.hi,
            "buckets_per_decade": self.buckets_per_decade,
            "underflow": self._underflow,
            "overflow": self._overflow,
            "invalid": self.invalid,
            # sparse: only non-empty buckets, as [upper_edge, count]
            "buckets": [
                [self._edges[i], c]
                for i, c in enumerate(self._counts)
                if c
            ],
        }


Instrument = Union[Counter, Gauge, Histogram]


class MetricsRegistry:
    """Flat name -> instrument registry with get-or-create accessors.

    Names are dot-paths (``engine.request.latency_s``); prefix-scoped
    ``reset`` gives episode-scoped counters their lifecycle without a
    second registry.
    """

    def __init__(self):
        self._instruments: Dict[str, Instrument] = {}

    def _get_or_create(self, name: str, factory, kind: str):
        inst = self._instruments.get(name)
        if inst is None:
            inst = factory()
            self._instruments[name] = inst
        elif inst.kind != kind:
            raise TypeError(
                f"metric {name!r} already registered as {inst.kind}, "
                f"requested {kind}"
            )
        return inst

    def counter(self, name: str) -> Counter:
        return self._get_or_create(name, lambda: Counter(name), "counter")

    def gauge(self, name: str) -> Gauge:
        return self._get_or_create(name, lambda: Gauge(name), "gauge")

    def histogram(
        self,
        name: str,
        *,
        lo: float = 1e-6,
        hi: float = 1e3,
        buckets_per_decade: int = 16,
    ) -> Histogram:
        return self._get_or_create(
            name,
            lambda: Histogram(
                name, lo=lo, hi=hi, buckets_per_decade=buckets_per_decade
            ),
            "histogram",
        )

    def get(self, name: str) -> Optional[Instrument]:
        return self._instruments.get(name)

    def names(self) -> List[str]:
        return sorted(self._instruments)

    def reset(self, prefix: Optional[str] = None) -> None:
        """Reset instruments in place (all, or those whose name starts
        with ``prefix``) — registrations survive, values zero."""
        for name, inst in self._instruments.items():
            if prefix is None or name.startswith(prefix):
                inst.reset()

    def snapshot(self) -> Dict[str, Dict]:
        return {
            name: inst.snapshot()
            for name, inst in sorted(self._instruments.items())
        }

    def write_json(self, path) -> None:
        """Deterministically ordered dump: instruments sort by name (via
        ``snapshot``), nested keys sort via ``sort_keys``, and bucket
        arrays are ascending-edge lists by construction — two runs over
        identical data produce byte-identical sidecars, so metrics
        artifacts diff cleanly across CI runs."""
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)
            f.write("\n")


def percentile_tolerance(buckets_per_decade: int) -> float:
    """The histogram's worst-case relative percentile error: one bucket
    ratio.  Test helper — asserts live in tests/test_obs.py."""
    return 10.0 ** (1.0 / buckets_per_decade)
