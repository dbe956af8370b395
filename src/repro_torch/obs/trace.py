"""Span tracing: a bounded ring of completed spans, Chrome trace export.

A ``TraceRecorder`` holds a bounded ring (``collections.deque`` with
``maxlen``) of *completed* spans, so recording never allocates unbounded
memory in an always-on loop; the oldest spans fall off the back.  The
trainer records one ``window`` span per sync window on its ``train``
track and straggler warnings as instants.

Timestamps are ``time.perf_counter()`` seconds; export shifts them to a
common zero.  ``chrome_trace()`` emits Chrome trace-event JSON (the
``traceEvents`` array format) loadable in Perfetto (ui.perfetto.dev) or
``chrome://tracing``: each distinct track becomes a named thread of one
``engine`` process, spans are ``ph: "X"`` complete events, instants are
``ph: "i"`` with thread scope.

``profiler_ns(t)`` puts a span's time on the clock of ``torch.profiler``'s
events (nanoseconds since the Unix epoch), so host spans and the device's
kernels can be read on one timeline: the hot path keeps ``perf_counter``,
and the offset between the two clocks is read when a time is converted.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import time
from typing import Callable, Dict, List, Optional

__all__ = ["Span", "TraceRecorder", "chrome_events", "profiler_ns"]


def profiler_ns(t: float) -> int:
    """The ``perf_counter`` time ``t`` (seconds, as spans hold it) on
    ``torch.profiler``'s clock: nanoseconds since the Unix epoch, as its
    events' ``start_ns()`` read.  The offset between the two clocks is
    read at each call, since a wall clock being slewed drifts from
    ``perf_counter`` (by up to 5 ms a second on a machine correcting its
    time): convert spans soon after they are recorded."""
    return round(t * 1e9) + time.time_ns() - time.perf_counter_ns()


@dataclasses.dataclass(frozen=True)
class Span:
    """One completed span (or instant, when ``t1 is None``)."""

    name: str
    t0: float  # perf_counter seconds
    t1: Optional[float]  # None -> instant event
    track: str = "engine"
    cat: str = "engine"
    args: Optional[Dict] = None

    @property
    def duration_s(self) -> float:
        return 0.0 if self.t1 is None else self.t1 - self.t0


class TraceRecorder:
    """Bounded ring of completed spans + Chrome trace-event export."""

    def __init__(self, capacity: int = 8192, enabled: bool = True):
        if capacity < 1:
            raise ValueError("trace capacity must be >= 1")
        self.capacity = int(capacity)
        self.enabled = bool(enabled)
        self._spans: "collections.deque[Span]" = collections.deque(
            maxlen=self.capacity
        )

    @staticmethod
    def now() -> float:
        return time.perf_counter()

    def span(
        self,
        name: str,
        t0: float,
        t1: float,
        *,
        track: str = "engine",
        cat: str = "engine",
        args: Optional[Dict] = None,
    ) -> None:
        """Record a completed span.  ``t1 < t0`` is rejected loudly —
        monotonic timestamps are an invariant the tests pin."""
        if not self.enabled:
            return
        if t1 < t0:
            raise ValueError(f"span {name!r}: t1 {t1} < t0 {t0}")
        self._spans.append(Span(name, t0, t1, track, cat, args))

    def instant(
        self,
        name: str,
        t: Optional[float] = None,
        *,
        track: str = "engine",
        cat: str = "engine",
        args: Optional[Dict] = None,
    ) -> None:
        if not self.enabled:
            return
        t = self.now() if t is None else t
        self._spans.append(Span(name, t, None, track, cat, args))

    def spans(self) -> List[Span]:
        """Snapshot of the ring, oldest first."""
        return list(self._spans)

    def clear(self) -> None:
        self._spans.clear()

    def __len__(self) -> int:
        return len(self._spans)

    # ------------------------------------------------------------ export
    def chrome_trace(self) -> Dict:
        """Chrome trace-event JSON object (``{"traceEvents": [...]}``),
        Perfetto-loadable.  Tracks map to threads of one process, in
        first-seen order; timestamps are microseconds from the earliest
        recorded span."""
        spans = self.spans()
        base = min((s.t0 for s in spans), default=0.0)
        return chrome_events(spans, lambda t: (t - base) * 1e6)

    def write(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_trace(), f, indent=1)
            f.write("\n")


def chrome_events(spans: List[Span], ts_us: Callable[[float], float],
                  pid: int = 1) -> Dict:
    """``spans`` as Chrome trace events of process ``pid`` (named
    ``snn_stream_engine``), each track a thread in first-seen order;
    ``ts_us`` maps a span time to the trace's microseconds."""
    tids: Dict[str, int] = {}
    events: List[Dict] = []
    for s in spans:
        tid = tids.setdefault(s.track, len(tids) + 1)
        ev = {
            "name": s.name,
            "cat": s.cat,
            "pid": pid,
            "tid": tid,
            "ts": ts_us(s.t0),
        }
        if s.args:
            ev["args"] = dict(s.args)
        if s.t1 is None:
            ev["ph"] = "i"
            ev["s"] = "t"  # thread-scoped instant
        else:
            ev["ph"] = "X"
            ev["dur"] = (s.t1 - s.t0) * 1e6
        events.append(ev)
    meta = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid,
            "args": {"name": "snn_stream_engine"},
        }
    ] + [
        {
            "name": "thread_name",
            "ph": "M",
            "pid": pid,
            "tid": tid,
            "args": {"name": track},
        }
        for track, tid in tids.items()
    ]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}
