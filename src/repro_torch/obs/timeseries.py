"""Windowed time-series sampling over a ``MetricsRegistry``.

The registry answers "what happened over the whole run"; this module
answers "what is happening *now*" — the signal an SLO burn-rate rule, a
load-shedding admission plane, or a dashboard needs.  A
``TimeSeriesSampler`` is pointed at a registry and ``sample()``d at
whatever cadence the caller owns (the trainer samples per log window).
Each sample captures:

- the **absolute value** of every tracked instrument (counter/gauge
  value, histogram count + sum),
- the **delta** of every counter-like value since the previous sample
  (with Prometheus-style reset detection: a value that went *down* is
  treated as a reset-to-zero followed by increments, so episode-scoped
  counters that reset mid-series keep their deltas non-negative and
  summable), and
- for explicitly listed histograms, the cumulative bucket counts — so a
  *windowed* histogram (and its p99) can be reconstructed as the
  difference of two cumulative snapshots.

Samples live in a bounded ring; cumulative delta totals are tracked
separately (``cum()``), so the "sum of deltas == lifetime total"
consistency check survives ring overflow.  Windowed **rates** divide
summed deltas by summed elapsed time (``rate()``), and windowed
**ratios** divide two counters' deltas (``ratio()`` — e.g. deadline
misses / completions = windowed miss-rate) instead of the lifetime
averages a snapshot gives.

``write_jsonl(path)`` exports the ring as a JSONL sidecar, one
self-describing object per line (``t``/``dt``/``values``/``deltas``).
Everything is plain Python; a sample is a few dict builds and float reads.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.metrics import Gauge, Histogram, MetricsRegistry

__all__ = ["Sample", "TimeSeriesSampler"]


@dataclasses.dataclass(frozen=True)
class Sample:
    """One timestamped capture of the tracked instruments."""

    t: float  # perf_counter seconds
    dt: float  # seconds since the previous sample (0.0 for the first)
    values: Dict[str, float]  # absolute instrument values
    deltas: Dict[str, float]  # counter-like deltas since previous sample
    buckets: Dict[str, Tuple[int, ...]]  # cumulative bucket counts
    # (underflow, *bucket_counts, overflow) for tracked histograms


def _instrument_values(inst) -> Dict[str, float]:
    """Flatten one instrument into the per-sample value dict.

    Counters/gauges contribute their value under their own name;
    histograms contribute ``<name>.count`` and ``<name>.sum`` (both
    monotone while un-reset, so they delta like counters and windowed
    means fall out as dsum/dcount).
    """
    if isinstance(inst, Histogram):
        return {f"{inst.name}.count": float(inst.count),
                f"{inst.name}.sum": float(inst.sum)}
    return {inst.name: float(inst.value)}


class TimeSeriesSampler:
    """Bounded ring of registry samples with windowed rate extraction."""

    def __init__(
        self,
        registry: MetricsRegistry,
        *,
        capacity: int = 4096,
        track_buckets: Sequence[str] = (),
        clock=time.perf_counter,
    ):
        if capacity < 2:
            raise ValueError("timeseries capacity must be >= 2")
        self.registry = registry
        self.capacity = int(capacity)
        self.track_buckets = tuple(track_buckets)
        self._clock = clock
        self.restart()

    # ------------------------------------------------------------ capture
    def restart(self) -> None:
        """Clear the ring and re-baseline deltas at the instruments'
        *current* values — the post-warmup reset point benchmarks use so
        warmup activity never leaks into windowed rates or the
        sum-of-deltas consistency check."""
        self._samples: List[Sample] = []
        self._prev: Dict[str, float] = {}
        self._cum: Dict[str, float] = {}
        self._t_prev: Optional[float] = None
        for name in self.registry.names():
            inst = self.registry.get(name)
            self._prev.update(_instrument_values(inst))

    def sample(self, t: Optional[float] = None) -> Sample:
        """Capture one sample; returns it (and appends it to the ring)."""
        t = self._clock() if t is None else float(t)
        values: Dict[str, float] = {}
        deltas: Dict[str, float] = {}
        buckets: Dict[str, Tuple[int, ...]] = {}
        for name in self.registry.names():
            inst = self.registry.get(name)
            vals = _instrument_values(inst)
            values.update(vals)
            if isinstance(inst, Gauge):
                continue  # gauges carry level, not flow: no delta
            for key, cur in vals.items():
                prev = self._prev.get(key, 0.0)
                # Prometheus-style reset detection: a monotone value
                # that went down was reset to zero and re-incremented
                d = cur if cur < prev else cur - prev
                deltas[key] = d
                self._cum[key] = self._cum.get(key, 0.0) + d
        for name in self.track_buckets:
            inst = self.registry.get(name)
            if isinstance(inst, Histogram):
                buckets[name] = (
                    inst._underflow, *inst._counts, inst._overflow
                )
        dt = 0.0 if self._t_prev is None else max(t - self._t_prev, 0.0)
        self._t_prev = t
        self._prev = values
        s = Sample(t=t, dt=dt, values=values, deltas=deltas,
                   buckets=buckets)
        self._samples.append(s)
        if len(self._samples) > self.capacity:
            del self._samples[0]
        return s

    # ------------------------------------------------------------ queries
    def __len__(self) -> int:
        return len(self._samples)

    def samples(self) -> List[Sample]:
        """Snapshot of the ring, oldest first."""
        return list(self._samples)

    def cum(self, key: str) -> float:
        """Cumulative delta total for ``key`` since the last restart —
        robust to ring overflow (it accumulates outside the ring), so
        ``baseline + cum == lifetime value`` always holds for counters
        that never reset."""
        return self._cum.get(key, 0.0)

    def span_s(self) -> float:
        """Wall-clock span the ring currently covers."""
        if len(self._samples) < 2:
            return 0.0
        return self._samples[-1].t - self._samples[0].t

    def _window(self, window_s: Optional[float]) -> List[Sample]:
        """Samples whose delta interval ends within the trailing window
        (the first sample carries no interval and never contributes)."""
        if not self._samples:
            return []
        if window_s is None:
            return self._samples[1:]
        t_end = self._samples[-1].t
        return [
            s for s in self._samples[1:] if t_end - s.t < window_s
        ]

    def window_sum(self, key: str, window_s: Optional[float] = None) -> float:
        """Summed deltas of ``key`` over the trailing window (whole
        series when ``window_s`` is None)."""
        return sum(s.deltas.get(key, 0.0) for s in self._window(window_s))

    def window_elapsed(self, window_s: Optional[float] = None) -> float:
        return sum(s.dt for s in self._window(window_s))

    def rate(self, key: str, window_s: Optional[float] = None) -> float:
        """Windowed rate (deltas per second) of a counter-like key —
        e.g. ``rate("engine.episode.events")`` is events/s over the
        window, not the lifetime average."""
        el = self.window_elapsed(window_s)
        return self.window_sum(key, window_s) / el if el > 0 else 0.0

    def ratio(
        self,
        num_key: str,
        den_key: str,
        window_s: Optional[float] = None,
    ) -> float:
        """Windowed ratio of two counters' deltas (e.g. deadline misses
        over completions = the windowed miss-rate).  0.0 when the
        denominator saw no flow in the window."""
        den = self.window_sum(den_key, window_s)
        return self.window_sum(num_key, window_s) / den if den > 0 else 0.0

    def windowed_histogram(
        self, name: str, window_s: Optional[float] = None
    ) -> Optional[Histogram]:
        """Reconstruct the histogram of values recorded *within* the
        trailing window as the difference of two cumulative bucket
        snapshots.  Needs ``name`` in ``track_buckets`` and >= 2 samples;
        returns None otherwise.  min/max are unknowable from bucket
        diffs, so the result leaves them infinite and percentiles clamp
        to bucket edges only."""
        if name not in self.track_buckets or len(self._samples) < 2:
            return None
        win = self._window(window_s)
        if not win:
            return None
        # base = the sample *before* the window's first interval
        first_idx = self._samples.index(win[0])
        base = self._samples[first_idx - 1].buckets.get(name)
        end = self._samples[-1].buckets.get(name)
        live = self.registry.get(name)
        if base is None or end is None or not isinstance(live, Histogram):
            return None
        h = Histogram(
            f"{name}.window", lo=live.lo, hi=live.hi,
            buckets_per_decade=live.buckets_per_decade,
        )
        diff = [max(e - b, 0) for e, b in zip(end, base)]
        h._underflow = diff[0]
        h._overflow = diff[-1]
        h._counts = diff[1:-1]
        h.count = sum(diff)
        # sum is reconstructible from the .sum delta series
        h.sum = self.window_sum(f"{name}.sum", window_s)
        # observed min/max are not recoverable from bucket diffs: clamp
        # percentiles to bucket geometry instead of observed extremes
        h.min = h.lo
        h.max = h._edges[-1]
        return h

    # ------------------------------------------------------------- export
    def summary(self, window_s: Optional[float] = None) -> Dict:
        """JSON-able summary of the trailing window: per-key rates for
        every delta key plus sample accounting."""
        el = self.window_elapsed(window_s)
        keys = sorted(
            {k for s in self._window(window_s) for k in s.deltas}
        )
        return {
            "samples": len(self._samples),
            "span_s": self.span_s(),
            "window_s": window_s,
            "window_elapsed_s": el,
            "rates_per_s": {k: self.rate(k, window_s) for k in keys},
        }

    def write_jsonl(self, path) -> None:
        """One JSON object per line, oldest sample first.  Keys are
        sorted so sidecars diff cleanly across runs of identical data."""
        with open(path, "w") as f:
            for s in self._samples:
                f.write(json.dumps(
                    {
                        "t": s.t,
                        "dt": s.dt,
                        "values": s.values,
                        "deltas": s.deltas,
                    },
                    sort_keys=True,
                ))
                f.write("\n")
