"""Runtime contract checkers for the invariants a static reading can't see.

The port of the reference's ``repro.analysis.contracts``, with its names:

- :class:`RecompileDetector` counts CUDA graph captures inside a region,
  per tracked callable against an allowlist of known capture sites, and
  process-wide.  A capture is the port's compile: the trainer's
  ``StaticStep`` captures once per batch signature (its ``_cache_size``),
  the serving engine's chunk once at cold start and once per ring growth
  (``graph_captures``, whose own allowlist ``_grow_ring`` extends) and
  its admission graphs once per (kind, T) at a ring size
  (``admit_captures``: a new signature extends the allowlist).
  Catches a shape-unstable path capturing again and again.
- :func:`donation_report` / :func:`verify_donation` read the argnums a
  callable declares donated (``donate_argnums``: the ``StaticStep``'s
  state, the engine chunk's states and meta); :func:`runtime_donation_check`
  calls it and checks that each donated argument's storages are the ones
  the call updated: the result holds them, or the call wrote them in place.
- :func:`aer_bounds_report` / :func:`check_aer_bounds` tie the event
  table's address dtype chosen by ``events.aer.addr_dtype_for`` to the
  layer widths and capacities it must index, so an int16 table can never
  silently wrap.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import threading
from typing import Any, Callable, Iterable, Mapping, Sequence

import torch

from repro_torch.tree import tree_leaves


class ContractViolation(AssertionError):
    """A machine-checked invariant does not hold."""


# ---------------------------------------------------------------------------
# re-capture detection
# ---------------------------------------------------------------------------

_active_detectors: "set[RecompileDetector]" = set()
_lock = threading.Lock()


def note_capture() -> None:
    """Called by every capture site of the port (``StaticStep``, the
    serving engine): one more capture for each active detector."""
    with _lock:
        for det in _active_detectors:
            det._backend_compiles += 1


@contextlib.contextmanager
def no_collection():
    """The garbage collector off around a capture.  A graph that a
    collection tears down while another is being captured makes a call
    that is illegal during a capture, and the capture fails; PyTorch no
    longer collects before capturing, so a dropped engine or trainer in a
    reference cycle could be torn down there.  Every capture site of the
    port wraps its ``torch.cuda.graph`` block in this."""
    collecting = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if collecting:
            gc.enable()


def _cache_size(fn: Any) -> int | None:
    """Lifetime captures of ``fn``: ``_cache_size()`` where it has one
    (the trainer's step), else ``graph_captures`` (the serving engine's
    chunk) plus ``admit_captures`` (its admission graphs)."""
    get = getattr(fn, "_cache_size", None)
    if get is not None:
        return int(get())
    n = getattr(fn, "graph_captures", None)
    if n is None:
        return None
    return int(n) + int(getattr(fn, "admit_captures", 0))


def _own_allowance(fn: Any) -> int:
    """Capture sites ``fn`` allowlists itself, lifetime: the engine's
    chunk at cold start and at each ring growth, and each admission
    signature, (kind, T) at a ring size, once; 0 for a callable without
    any."""
    return int(getattr(fn, "_captures_expected", 0)) + int(
        getattr(fn, "_admit_captures_expected", 0))


@dataclasses.dataclass
class _Tracked:
    fn: Any
    start: int | None
    own_start: int
    allowed: int
    end: int | None = None  # frozen at region exit
    own_end: int | None = None


class RecompileDetector:
    """Count graph captures inside a region.

    >>> with RecompileDetector() as det:
    ...     det.track("step", trainer.step_fn, allowed=1)  # cold start
    ...     trainer.run(state, batches, 100)
    >>> det.raise_on_unexpected()

    ``track()`` registers a capturing callable whose capture count growth
    is measured; ``allowed`` is that site's capture budget for the region
    (the allowlist of known capture sites), to which the callable's own
    allowlist adds what it grew in the region (the engine's ring growth).
    ``backend_compiles`` counts every capture any capture site of the
    port made while the detector was active, tracked or not.
    """

    def __init__(self, max_backend_compiles: int | None = None):
        self._tracked: dict[str, _Tracked] = {}
        self._backend_compiles = 0
        self._max_backend = max_backend_compiles

    def __enter__(self) -> "RecompileDetector":
        with _lock:
            _active_detectors.add(self)
        return self

    def __exit__(self, *exc: Any) -> None:
        with _lock:
            _active_detectors.discard(self)
        # freeze growth at region exit: report()/unexpected() called later
        # describe the guarded region, not captures after it
        for t in self._tracked.values():
            if t.start is not None and t.end is None:
                t.end = _cache_size(t.fn)
                t.own_end = _own_allowance(t.fn)

    def track(self, name: str, fn: Any, allowed: int = 0) -> None:
        """Register a capturing callable; capture growth beyond
        ``allowed`` (plus its own allowlist's growth) is unexpected."""
        self._tracked[name] = _Tracked(fn, _cache_size(fn), _own_allowance(fn),
                                       allowed)

    @property
    def backend_compiles(self) -> int:
        return self._backend_compiles

    def cache_growth(self, name: str) -> int | None:
        t = self._tracked[name]
        if t.start is None:
            return None
        now = t.end if t.end is not None else _cache_size(t.fn)
        return None if now is None else now - t.start

    def allowed(self, name: str) -> int:
        """The site's budget: ``allowed`` plus its own allowlist's growth."""
        t = self._tracked[name]
        own = t.own_end if t.own_end is not None else _own_allowance(t.fn)
        return t.allowed + own - t.own_start

    def report(self) -> dict:
        per_fn = {}
        for name in self._tracked:
            growth = self.cache_growth(name)
            allowed = self.allowed(name)
            per_fn[name] = {
                "cache_growth": growth,
                "allowed": allowed,
                "unexpected": None if growth is None else growth - allowed,
            }
        return {
            "backend_compiles": self._backend_compiles,
            "max_backend_compiles": self._max_backend,
            "tracked": per_fn,
        }

    def unexpected(self) -> list[str]:
        """Human-readable list of allowlist violations (empty == clean)."""
        out = []
        for name in self._tracked:
            growth, allowed = self.cache_growth(name), self.allowed(name)
            if growth is not None and growth > allowed:
                out.append(
                    f"`{name}` captured {growth} time(s), allowlist permits "
                    f"{allowed} — shape-unstable inputs?"
                )
        if (self._max_backend is not None
                and self._backend_compiles > self._max_backend):
            out.append(
                f"{self._backend_compiles} graph captures observed in region "
                f"(budget {self._max_backend}) — untracked site capturing"
            )
        return out

    def raise_on_unexpected(self) -> None:
        bad = self.unexpected()
        if bad:
            raise ContractViolation("; ".join(bad))


# ---------------------------------------------------------------------------
# donation / in-place verification
# ---------------------------------------------------------------------------


def _tensor_leaves(tree: Any) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def donation_report(fn: Any, *args: Any, **kwargs: Any) -> dict:
    """Report which user argnums ``fn`` donates, from the
    ``donate_argnums`` it declares (none where it declares nothing), with
    the flat tensor-leaf indices they cover: the shape of the reference's
    report of a lowered module's aliasing attributes."""
    declared = set(getattr(fn, "donate_argnums", ()))
    leaf_counts = [len(_tensor_leaves(a)) for a in args]
    donated_flat, lo = [], 0
    for argnum, n in enumerate(leaf_counts):
        if argnum in declared:
            donated_flat += range(lo, lo + n)
        lo += n
    return {
        "flat_args": lo,
        "donated_flat": donated_flat,
        "donated_argnums": sorted(a for a in declared if a < len(args)
                                  and leaf_counts[a]),
        "leaf_counts": leaf_counts,
    }


def verify_donation(fn: Any, args: Sequence[Any],
                    expect_donated: Iterable[int]) -> dict:
    """Raise :class:`ContractViolation` unless every argnum in
    ``expect_donated`` is donated by ``fn``."""
    rep = donation_report(fn, *args)
    missing = sorted(set(expect_donated) - set(rep["donated_argnums"]))
    if missing:
        raise ContractViolation(
            f"argnums {missing} are not donated "
            f"(donated: {rep['donated_argnums']})"
        )
    return rep


def runtime_donation_check(
    fn: Callable[..., Any], args: Sequence[Any], donated: Iterable[int]
) -> Any:
    """Call ``fn(*args)`` and verify the donated inputs were consumed: the
    call's updates of each donated argument landed in its storages, so
    some tensor leaf of it is a storage of the result or was written in
    place (its version counter moved; a graph replay writes without moving
    it, so a graphed step shows by the first).  A leaf the call leaves as
    it was (the engine's ``meta["total"]``) is allowed; an argument none of
    whose leaves the call returned or wrote was copied, not donated.
    Returns the call's result."""
    donated = sorted(set(donated))
    before = {a: [x._version for x in _tensor_leaves(args[a])] for a in donated}
    out = fn(*args)
    held = {x.data_ptr() for x in _tensor_leaves(out) if x.numel()}
    not_written = [
        a for a in donated
        if not any(x._version != v or (x.numel() and x.data_ptr() in held)
                   for x, v in zip(_tensor_leaves(args[a]), before[a]))
    ]
    if not_written:
        raise ContractViolation(
            f"donated argnums {not_written} still hold storages the call "
            "neither returned nor wrote — donation silently dropped (the "
            "call copied its state instead of updating it in place)"
        )
    return out


# ---------------------------------------------------------------------------
# AER address-width bounds
# ---------------------------------------------------------------------------

_INT32_MAX = torch.iinfo(torch.int32).max


def aer_bounds_report(
    layer_sizes: Sequence[int],
    capacities: Mapping[int, int] | Sequence[int] | None = None,
    num_steps: int | None = None,
) -> dict:
    """Check every event table's address dtype against the width it must
    index, and the int8 value / int32 count lanes against their ranges.
    Layer 0 is the input plane; layer ``i`` feeds addresses in
    ``[0, layer_sizes[i])``."""
    from repro_torch.events import aer

    layers = []
    ok = True
    for i, width in enumerate(layer_sizes):
        dtype = aer.addr_dtype_for(width)
        max_addr = int(torch.iinfo(dtype).max)
        fits = width - 1 <= max_addr
        ok &= fits
        cap = None
        if capacities is not None:
            try:
                cap = capacities[i]  # works for both dict and sequence
            except (KeyError, IndexError):
                cap = None
        cap_fits = cap is None or cap <= _INT32_MAX
        ok &= cap_fits
        layers.append(
            {
                "layer": i,
                "width": int(width),
                "addr_dtype": str(dtype).removeprefix("torch."),
                "max_addr": max_addr,
                "addr_fits": bool(fits),
                "capacity": None if cap is None else int(cap),
                "count_fits_int32": bool(cap_fits),
            }
        )
    # value lane: spike values are 0/1 (small counts when merged); int8
    # holds them as long as the per-step multiplicity stays below 128
    value_headroom = int(torch.iinfo(torch.int8).max)
    if num_steps is not None:
        ok &= num_steps < 2**31
    return {"ok": bool(ok), "layers": layers, "value_max": value_headroom}


def check_aer_bounds(
    layer_sizes: Sequence[int],
    capacities: Mapping[int, int] | Sequence[int] | None = None,
) -> list[str]:
    """Return violation strings (empty == clean)."""
    rep = aer_bounds_report(layer_sizes, capacities)
    out = []
    for lay in rep["layers"]:
        if not lay["addr_fits"]:
            out.append(
                f"layer {lay['layer']}: width {lay['width']} overflows "
                f"{lay['addr_dtype']} addresses (max {lay['max_addr']})"
            )
        if not lay["count_fits_int32"]:
            out.append(
                f"layer {lay['layer']}: capacity {lay['capacity']} overflows "
                "int32 counts"
            )
    return out
