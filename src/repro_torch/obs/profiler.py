"""Tick-phase profiling: ``torch.profiler`` capture + dispatch attribution.

Two instruments for the question *where does a tick's time go?*

- ``profile_ticks(engine, ...)`` arms a ``torch.profiler`` window around
  N steady-state engine ticks (skipping warm-up polls, so the first
  tick's kernel build and graph capture never pollute the capture) and
  writes a Chrome trace (``trace.json``) into ``logdir``, loadable in
  Perfetto.  On the card it records device kernels beside the host tick
  loop; the engine's own spans of those ticks are added to the file on
  the profiler's clock (``obs.trace.profiler_ns``), so they share the
  kernels' timeline.
- ``dispatch_attribution(fn, *args)`` is a blocking probe: it times the
  call *returning* (host enqueue: Python, launches or a graph replay)
  apart from the wait for the device to finish, splitting the engine's
  ``dispatch_us`` bucket into "host overhead to attack" and "the device
  was simply busy".  On the card the device time of the call is also
  read from CUDA events around it; on the CPU everything is the host
  clock and the wait is ~0.

``tick_instrumentation_cost_us(...)`` microbenches the exact
metrics/trace operations one engine tick performs, including the
per-poll time-series sample, against *scratch* instruments, so the cost
of the observability layer can be set against a measured tick without
perturbing a live registry.  A port of the reference's
``repro.obs.profiler``.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import TraceRecorder, chrome_events, profiler_ns

__all__ = [
    "profile_ticks",
    "dispatch_attribution",
    "tick_instrumentation_cost_us",
]

# the process id of the engine's spans in a profiled trace: apart from
# the profiler's own (the host process's id, the devices' indices)
SPANS_PID = 1 << 30


class _TickProfileHandle:
    """Wraps ``engine.poll``: starts the profiler after ``skip`` polls,
    stops it ``num_ticks`` polls later, writes the trace, then restores
    the original ``poll``.  ``stop()`` is idempotent and safe to call
    early (e.g. the serve loop drained first)."""

    def __init__(self, engine, logdir: str, num_ticks: int, skip: int):
        self._engine = engine
        self.logdir = str(logdir)
        self.num_ticks = int(num_ticks)
        self._skip = int(skip)
        self._seen = 0
        self._prof = None
        self.stopped = False
        self.error: Optional[str] = None
        self.trace_path: Optional[str] = None
        self._t_start: Optional[float] = None
        self._orig_poll = engine.poll
        self._shadowed = "poll" in vars(engine)
        engine.poll = self._wrapped_poll  # instance attr shadows method

    def _restore_poll(self) -> None:
        if self._shadowed:
            self._engine.poll = self._orig_poll
        else:
            del self._engine.poll  # the class's method shows through again

    def _start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self._engine.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
            self._prof = prof
            self._t_start = time.perf_counter()
        except Exception as e:  # profiler backend unavailable
            self.error = f"torch.profiler start failed: {e}"
            self.stopped = True
            self._restore_poll()

    def _wrapped_poll(self):
        if self._prof is None and not self.stopped:
            if self._seen >= self._skip:
                self._start()
            else:
                self._seen += 1
        out = self._orig_poll()
        if self._prof is not None and not self.stopped:
            self._seen += 1
            if self._seen >= self._skip + self.num_ticks:
                self.stop()
        return out

    def stop(self) -> None:
        if self.stopped:
            return
        self.stopped = True
        self._restore_poll()
        if self._prof is None:
            return
        if self._engine.device.type == "cuda":
            # the capture includes the in-flight chunk's device time
            torch.cuda.synchronize(self._engine.device)
        t_stop = time.perf_counter()
        try:
            self._prof.__exit__(None, None, None)
            os.makedirs(self.logdir, exist_ok=True)
            self.trace_path = os.path.join(self.logdir, "trace.json")
            self._prof.export_chrome_trace(self.trace_path)
        except Exception as e:
            self.error = f"torch.profiler stop/export failed: {e}"
            return
        try:
            self._add_engine_spans(t_stop)
        except Exception as e:  # the profiler's own trace stays as written
            self.error = f"adding the engine's spans to the trace failed: {e}"

    def _add_engine_spans(self, t_stop: float) -> None:
        """Append the engine's spans that started inside the capture to the
        trace file, on the profiler's clock, as a process of their own."""
        spans = [s for s in self._engine.trace.spans()
                 if self._t_start <= s.t0 <= t_stop]
        with open(self.trace_path) as f:
            doc = json.load(f)
        # the file's times are microseconds from its base, where it has one
        base_ns = int(doc.get("baseTimeNanoseconds", 0))
        added = chrome_events(
            spans, lambda t: (profiler_ns(t) - base_ns) / 1e3, SPANS_PID)
        doc.setdefault("traceEvents", []).extend(added["traceEvents"])
        tmp = self.trace_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, self.trace_path)


def profile_ticks(
    engine, logdir: str, num_ticks: int = 20, skip: int = 2
) -> _TickProfileHandle:
    """Arm a ``torch.profiler`` capture around the engine's next
    ``num_ticks`` steady-state polls (after ``skip`` warm-up polls).

    Returns a handle; call ``handle.stop()`` after serving (idempotent:
    a no-op if the tick budget already closed the capture).  Works for
    both a ``poll()`` driver and the closed-loop ``run()`` wrapper, which
    funnels through ``poll``.
    """
    if num_ticks < 1:
        raise ValueError("num_ticks must be >= 1")
    return _TickProfileHandle(engine, logdir, num_ticks, max(0, skip))


def dispatch_attribution(
    fn, *args, warmup: int = 1, iters: int = 5, device=None
) -> Dict:
    """Split a call's wall time into host enqueue and device wait.

    Times ``fn(*args)`` *returning* (enqueue) apart from the wait until
    the card has finished it (``device_wait``).  On the card (``device``,
    by default the current CUDA device when there is one) CUDA events
    recorded around the call also give ``device_us``, the card's time
    from the call's first launch to its last; on the CPU ``device_us`` is
    None.
    Medians over ``iters``; each iteration waits before the next, so work
    never queues up.  Pass a function that may run repeatedly on the same
    arguments (``engine.chunk_for_timing()``, or a graph's ``replay``).
    """
    if device is None:
        on_card = torch.cuda.is_available()
    else:
        on_card = torch.device(device).type == "cuda"
    dev = device if on_card else None
    for _ in range(warmup):
        fn(*args)
        if on_card:
            torch.cuda.synchronize(dev)
    enq, tot, dev_ms = [], [], []
    for _ in range(iters):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        fn(*args)
        t1 = time.perf_counter()
        if on_card:
            end.record()
            end.synchronize()
        t2 = time.perf_counter()
        enq.append(t1 - t0)
        tot.append(t2 - t0)
        if on_card:
            dev_ms.append(start.elapsed_time(end))
    enq.sort()
    tot.sort()
    dev_ms.sort()
    enqueue_s = enq[len(enq) // 2]
    total_s = max(tot[len(tot) // 2], enqueue_s)
    device_wait_s = total_s - enqueue_s
    frac = device_wait_s / total_s if total_s > 0 else 0.0
    if frac >= 0.5:
        verdict = (
            "device-compute wait dominates: dispatch_us is the chunk's "
            "actual compute, not host dispatch overhead to attack"
        )
    else:
        verdict = (
            "host enqueue dominates: dispatch_us is Python/launch "
            "overhead — attack the host path"
        )
    return {
        "host_enqueue_us": enqueue_s * 1e6,
        "device_wait_us": device_wait_s * 1e6,
        "total_us": total_s * 1e6,
        "device_wait_frac": frac,
        "device_us": dev_ms[len(dev_ms) // 2] * 1e3 if dev_ms else None,
        "iters": iters,
        "verdict": verdict,
    }


def tick_instrumentation_cost_us(
    num_slots: int, reps: int = 2000
) -> float:
    """Measured cost (µs) of the metrics/trace work one engine tick
    performs, against scratch instruments: 3 tick-phase histogram
    records + 3 tick-phase spans (the dispatch span carrying the
    request ids of the ``num_slots`` dispatched slots), the
    counter/gauge updates ``_tick``/``_retire`` make, and one
    time-series sample (with latency-bucket tracking) as taken each
    ``poll()``.  ``submit`` takes no sample of its own."""
    from repro_torch.obs.timeseries import TimeSeriesSampler

    reg = MetricsRegistry()
    rec = TraceRecorder(capacity=1024)
    hs = [
        reg.histogram(f"probe.tick.{k}_s", lo=1e-7, hi=10.0)
        for k in ("host_prep", "dispatch", "stats_fetch")
    ]
    lat = reg.histogram("probe.request.latency_s", lo=1e-6, hi=1e3)
    lat.record(0.05)
    ticks = reg.counter("probe.ticks")
    events = reg.counter("probe.events")
    steps = reg.counter("probe.steps")
    depth = reg.gauge("probe.queue_depth")
    sampler = TimeSeriesSampler(
        reg, capacity=4096, track_buckets=("probe.request.latency_s",)
    )
    slot_req = list(range(num_slots))
    take = np.full(num_slots, 5, np.int32)
    t_start = time.perf_counter()
    for i in range(reps):
        t0 = time.perf_counter()
        for h in hs:
            h.record(1.1e-3)
        rec.span("host_prep", t0, t0 + 1e-5, track="tick")
        rec.span(
            "dispatch", t0, t0 + 1e-3, track="tick",
            args={"steps": int(take.sum()),
                  "rids": [slot_req[s] for s in np.flatnonzero(take)]},
        )
        rec.span("stats_fetch", t0, t0 + 1e-4, track="tick")
        ticks.inc()
        events.inc(1234.0)
        steps.inc(20.0)
        depth.set(float(i % 7))
        lat.record(0.01 * (1 + i % 3))
        sampler.sample()
    return (time.perf_counter() - t_start) / reps * 1e6
