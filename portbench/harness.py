"""What every cell's run shares: the environment and caches, the card's
checks and facts, the traced window and its reduction, the import guard,
and the result line.

Nothing here imports the program: a driver hands in the system under
test, and the harness only times, traces and prints.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

# top-level module names that must not be loaded in a run's process: the
# JAX stack, the JAX package the port was made from, and its CPU benches
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")

DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
# the spans that hold a whole window, never the name of an idle gap
OUTER = ("window", "measured")


class NoCard(SystemExit):
    """Raised where the run needs cards it does not have."""


def set_cache_dirs(checkout: Path) -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout, so only a cell's first run in it builds.  Set before
    torch is imported.  ``USE_FLAX``/``USE_JAX`` keep libraries that
    could load JAX on their own from doing so."""
    cache = checkout / "build" / "portbench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda_jit")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def host_threads(n: Optional[int]) -> None:
    """The host threads of the run's process, where a traffic file gives
    ``host_threads``: set before torch and numpy load (and in torch, where
    it is loaded already).  A host-paced cell's copies and checks then
    keep to few of a shared machine's cores."""
    if n is None:
        return
    os.environ["OMP_NUM_THREADS"] = str(int(n))
    if "torch" in sys.modules:
        sys.modules["torch"].set_num_threads(int(n))


def require_cards(torch, n: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("portbench: torch.cuda.is_available() is false: no "
                     "card, no result")
    have = torch.cuda.device_count()
    if have < n:
        raise NoCard(f"portbench: the cell needs {n} cards, "
                     f"torch.cuda.device_count() is {have}: no result")


def card_facts() -> Dict[str, str]:
    """The card's name, SM clock and power limit from ``nvidia-smi`` (a
    card may be set below its 700 W, and then runs slower)."""
    q = "name,clocks.sm,clocks.max.sm,power.limit"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        vals = [v.strip() for v in out.stdout.splitlines()[0].split(",")]
        return dict(zip(q.split(","), vals))
    except (OSError, subprocess.SubprocessError, IndexError) as err:
        return {"nvidia-smi": f"unavailable ({err})"}


def forbidden_loaded(modules: Optional[Iterable[str]] = None) -> List[str]:
    """The names among ``modules`` (by default the loaded ones) whose
    top-level name, compared whole, is one of ``FORBIDDEN``
    (``repro_torch`` is not ``repro``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def refuse_forbidden() -> None:
    """Ends the run with no result, naming them on standard error, when
    forbidden modules are loaded in its process."""
    loaded = forbidden_loaded()
    if loaded:
        raise SystemExit(f"portbench: modules {loaded} were loaded in the "
                         f"run's process: no result")


def nearest_rank(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (0 < q <= 100) by nearest rank: a value of
    the sample itself, exact over all of it."""
    if not values:
        raise ValueError("percentile of no values")
    s = sorted(values)
    return s[max(1, math.ceil(q / 100.0 * len(s))) - 1]


def histogram_delta(before: Dict, after: Dict) -> Dict:
    """What a ``MetricsRegistry`` histogram recorded between two of its
    snapshots: count, sum and the bucket counts (underflow apart)."""
    b_buckets = {e: c for e, c in before.get("buckets", [])}
    buckets = []
    for edge, c in after.get("buckets", []):
        d = c - b_buckets.get(edge, 0)
        if d:
            buckets.append([edge, d])
    return {"count": after["count"] - before["count"],
            "sum": after["sum"] - before["sum"],
            "lo": after["lo"], "buckets_per_decade":
            after["buckets_per_decade"],
            "underflow": after["underflow"] - before["underflow"],
            "buckets": buckets}


def histogram_percentile(delta: Dict, q: float) -> Optional[float]:
    """Nearest-rank percentile over a histogram delta's buckets, with the
    geometric interpolation inside the landing bucket that the program's
    histogram uses (its edges are log-spaced).  None when empty."""
    n = delta["count"]
    if n <= 0:
        return None
    target = max(1, math.ceil(q / 100.0 * n))
    cum = delta["underflow"]
    if target <= cum:
        return delta["lo"]
    ratio = 10.0 ** (1.0 / delta["buckets_per_decade"])
    for upper, c in delta["buckets"]:
        if target <= cum + c:
            lower = max(upper / ratio, delta["lo"])
            return lower * (upper / lower) ** ((target - cum) / c)
        cum += c
    return delta["buckets"][-1][0] if delta["buckets"] else None


# ---------------------------------------------------------------- spans
class Spans:
    """The harness's own spans around its calls into the program's layers
    (host clock), also handed to the profiler as annotations when a run
    is traced, so an idle gap on the card is named by what the host was
    doing."""

    def __init__(self, torch=None, traced: bool = False):
        self._torch = torch
        self.traced = traced
        self.sums: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        rf = (self._torch.profiler.record_function(f"pb.{name}")
              if self.traced else contextlib.nullcontext())
        t0 = time.perf_counter()
        with rf:
            yield
        dt = time.perf_counter() - t0
        self.sums[name] = self.sums.get(name, 0.0) + dt


@contextlib.contextmanager
def traced(torch, enabled: bool):
    """``torch.profiler`` over the window when ``enabled`` (CPU and CUDA
    activity), else nothing.  Yields the profiler or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def _on_device(ev) -> bool:
    """Whether a kineto event ran on the card (a kernel, copy or fill).
    Builds without ``activity_type`` tell by the event's device type."""
    kind = getattr(ev, "activity_type", None)
    if kind is not None:
        return kind() in DEVICE_OPS
    return "CUDA" in str(ev.device_type())


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(ev, f"{what}_us")() * 1000)


def reduce_trace(events: Iterable, t_begin_ns: Optional[int] = None,
                 t_end_ns: Optional[int] = None) -> Dict:
    """The profiler's events as the per-layer readers and the breakdown
    take them.  ``events`` are kineto events (``name()``, ``start_ns()``,
    ``duration_ns()``, ``activity_type()``).  Device operations (kernels,
    copies, fills) become ``kernels`` [(name, start_ns, dur_ns)]; the
    harness's ``pb.*`` annotations ``annotations``.  ``busy_s`` is the
    union of the device operations' intervals, so overlapping ones count
    once; ``window_s`` the traced window (the annotations' span unless
    given: the ``measured`` annotation's, where the driver made one);
    ``idle_gaps`` the longest gaps between device operations,
    each named by the innermost annotation the host was in at its start."""
    kernels, notes = [], []
    for ev in events:
        name = ev.name()
        on_device = _on_device(ev)
        if name.startswith("pb."):
            if not on_device:
                start = _ns(ev, "start")
                notes.append((name[3:], start, start + _ns(ev, "duration")))
        elif on_device:
            kernels.append((name, _ns(ev, "start"), _ns(ev, "duration")))
    measured = [n for n in notes if n[0] == "measured"]
    if t_begin_ns is None and measured:
        t_begin_ns, t_end_ns = measured[0][1], measured[0][2]
    if t_begin_ns is None:
        t_begin_ns = min((s for _, s, _ in notes), default=None)
        t_end_ns = max((e for _, _, e in notes), default=None)
    if t_begin_ns is None and kernels:
        t_begin_ns = min(s for _, s, _ in kernels)
        t_end_ns = max(s + d for _, s, d in kernels)
    window_ns = max((t_end_ns or 0) - (t_begin_ns or 0), 0)
    if t_begin_ns is not None:
        kernels = [k for k in kernels
                   if k[1] + k[2] > t_begin_ns and k[1] < t_end_ns]
    merged = _merge([(max(s, t_begin_ns), min(s + d, t_end_ns))
                     for _, s, d in kernels
                     if s + d > t_begin_ns and s < t_end_ns])
    busy_ns = sum(e - s for s, e in merged)
    by_name: Dict[str, float] = {}
    for name, _, d in kernels:
        by_name[name] = by_name.get(name, 0.0) + d / 1e9
    gaps = []
    edges = [t_begin_ns] + [x for iv in merged for x in iv] + [t_end_ns]
    for i in range(0, len(edges), 2):
        g0, g1 = edges[i], edges[i + 1]
        if g1 - g0 > 0:
            gaps.append((g0, g1))
    notes.sort(key=lambda n: n[1])
    starts = [n[1] for n in notes]
    named: Dict[str, float] = {}
    for g0, g1 in gaps:
        # the innermost annotation covering g0 is the latest-starting one
        # that has not ended; the harness's spans nest, so a few steps
        # back reach it or the window's own
        label = "none"
        i = bisect.bisect_right(starts, g0) - 1
        for j in range(i, max(i - 16, -1), -1):
            if notes[j][2] > g0 and notes[j][0] not in OUTER:
                label = notes[j][0]
                break
        else:
            if any(n[1] <= g0 < n[2] for n in notes if n[0] in OUTER):
                label = "measured"
        named[label] = named.get(label, 0.0) + (g1 - g0) / 1e9
    return {
        "kernels": kernels,
        "busy_s": busy_ns / 1e9,
        "window_s": window_ns / 1e9,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(named.items(), key=lambda kv: -kv[1])[:10],
    }


def idle_pct(trace: Optional[Dict]) -> Optional[float]:
    """Share of the traced window in which no operation ran on the card
    (%); None without a trace that saw the card work."""
    if not trace or trace["window_s"] <= 0 or trace["busy_s"] <= 0:
        return None
    return (1.0 - trace["busy_s"] / trace["window_s"]) * 100


def kernel_stats(trace: Optional[Dict], needle: str) -> Optional[Tuple[int, float]]:
    """(launches, device seconds) of the traced kernels whose name holds
    ``needle``; None when the trace has none."""
    if not trace:
        return None
    durs = [d for name, _, d in trace["kernels"] if needle in name]
    if not durs:
        return None
    return len(durs), sum(durs) / 1e9


# ---------------------------------------------------------------- output
def check_line(name: str, value: float, limit: float, ok: bool) -> str:
    return (f"check {name}: {value!r} limit {limit!r} "
            f"{'ok' if ok else 'FAILED'}")


def emit(result: Dict, checks: Dict[str, Dict]) -> None:
    """The run's last lines: each number compared beside its limit on
    standard error, then the result line on standard output, with the
    checks under a key of their own that comes last."""
    for name, c in checks.items():
        print(check_line(name, c["value"], c["limit"], c["ok"]),
              file=sys.stderr)
    sys.stderr.flush()
    line = dict(result)
    line["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                      for k, c in checks.items()}
    print(json.dumps(line), flush=True)
