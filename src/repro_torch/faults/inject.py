"""Deterministic fault injection for the SNN stream engine.

Chaos testing needs *reproducible* chaos: a seeded
:class:`FaultSchedule` is a plain list of :class:`Fault` records, and a
:class:`FaultInjector` applies them against a live ``SNNStreamEngine``
from inside its tick loop.  Six fault kinds cover the engine's real
failure surfaces:

``nan_membrane``
    Flips one membrane potential of a resident slot to NaN on the
    device — the canonical "poisoned state" fault.  The engine's
    in-graph fault checks must detect it in the next chunk, quarantine
    exactly that slot, and keep the other S-1 slots bit-identical to a
    fault-free run.
``corrupt_ring``
    Overwrites the slot's staged per-step event *count* at its current
    ``done`` offset with an impossible value (negative), modelling a
    corrupted AER table.  Detected by the chunk's in-window count-range
    check.
``chunk_exception``
    Arms the injector to raise :class:`InjectedChunkError` from the
    next ``times`` chunk dispatches (optionally only while the engine
    runs a given backend) — exercising the retry supervisor and, for
    persistent fused-only failures, the fused->torch demotion path.
``stall``
    Freezes the tick loop for ``ticks`` ticks (no dispatch, no
    retirement) — the wedge ``drain(timeout_s=...)`` must survive.
``process_kill``
    Delivers SIGKILL to the *current process* at the scheduled tick —
    no atexit handlers, no flushes, exactly what a preempted node or an
    OOM-killer does.  Only meaningful inside a chaos subprocess (the
    kill-and-resume tests); the engine's snapshot/restore and the
    checkpoint manager's atomic-write discipline are what must survive
    it.
``corrupt_checkpoint``
    Flips bytes in the ``arrays.npz`` of the checkpoint/snapshot at
    ``path`` (the newest ``step_*``/``snap_*`` dir when ``path`` is a
    rotation directory), modelling disk corruption or a torn copy.  The
    manifest checksums must detect it and ``restore_latest`` /
    ``restore_latest_snapshot`` must fall back to the previous save.

Application is governed by *injectability*: state/ring faults need a
slot that is resident, mid-window, and past its admit tick (a freshly
admitted slot is zeroed in-graph, which would silently swallow the
fault).  A fault whose scheduled tick arrives with no injectable slot
is carried forward to the next tick that has one, so a seeded schedule
of N state/ring faults yields exactly N applications (and therefore N
quarantines) on any sufficiently long run — the invariant the chaos
acceptance test pins.  Every application is recorded in
``injector.applied`` (tick, kind, slot, rid) so tests can join
injections against the engine's quarantine log and measure recovery
ticks.

State and ring faults write **in place** into the static buffers of
the slot's shard (``shard._states[l].u[r, 0] = nan``,
``shard._ring["counts"][r, off] = -7`` at the slot's row ``r``; an
unsharded engine is its one shard), as a CUDA kernel's stray write
would.  The shard's CUDA graph holds those buffers' addresses: a fault
that rebound the states or the ring to new tensors would never reach the
replayed chunk, and would vanish without a sign.  On the card the
write is a small fill ordered on the current stream, ahead of the next
replay.

The port of ``repro.faults.inject``; ``only_backend`` takes the port's
backend names (``"fused"``, ``"torch"``, ``"fused_ref"``).
"""

from __future__ import annotations

import dataclasses
import os
import signal
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "Fault",
    "FaultSchedule",
    "FaultInjector",
    "InjectedChunkError",
    "FAULT_KINDS",
    "corrupt_checkpoint",
]

FAULT_KINDS = (
    "nan_membrane",
    "corrupt_ring",
    "chunk_exception",
    "stall",
    "process_kill",
    "corrupt_checkpoint",
)


def corrupt_checkpoint(path: str, *, seed: int = 0, nbytes: int = 8) -> str:
    """Deterministically flip ``nbytes`` bytes in the ``arrays.npz`` of
    the checkpoint/snapshot at ``path``.

    ``path`` may be the array dir itself or a rotation directory
    containing ``step_*``/``snap_*`` subdirs (the newest is hit —
    exactly the one ``restore_latest`` would try first, forcing the
    fallback).  Returns the corrupted npz path.  The manifest is left
    intact: detection must come from the checksum verification, not
    from an unreadable manifest."""
    target = path
    if not os.path.exists(os.path.join(target, "arrays.npz")):
        subs = sorted(
            d for d in os.listdir(path)
            if d.startswith(("step_", "snap_"))
            and os.path.exists(os.path.join(path, d, "arrays.npz"))
        )
        if not subs:
            raise FileNotFoundError(
                f"no checkpoint arrays.npz under {path}"
            )
        target = os.path.join(path, subs[-1])
    npz = os.path.join(target, "arrays.npz")
    data = bytearray(open(npz, "rb").read())
    rng = np.random.default_rng(seed)
    # flip bytes in the back half: past the zip header/manifest region,
    # inside some array's payload, so the crc32 check is what trips
    lo = len(data) // 2
    for off in rng.integers(lo, len(data), size=int(nbytes)):
        data[int(off)] ^= 0xFF
    with open(npz, "wb") as f:
        f.write(bytes(data))
    return npz


class InjectedChunkError(RuntimeError):
    """Raised by the injector from inside chunk dispatch."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault.

    ``tick`` is the earliest engine tick it may fire.  ``slot`` is a
    *preference* for state/ring faults (falls back to any injectable
    slot).  ``times`` is how many dispatches a ``chunk_exception``
    poisons; ``ticks`` how long a ``stall`` lasts; ``only_backend``
    restricts a ``chunk_exception`` to dispatches on that backend
    (``"fused"`` faults vanish after demotion — the failover scenario).
    ``path`` is the checkpoint/snapshot directory a
    ``corrupt_checkpoint`` fault flips bytes in.
    """

    tick: int
    kind: str
    slot: Optional[int] = None
    layer: int = 0
    times: int = 1
    ticks: int = 1
    only_backend: Optional[str] = None
    path: Optional[str] = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}"
            )
        if self.tick < 0:
            raise ValueError("fault tick must be >= 0")


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """An immutable, seed-reproducible list of faults."""

    faults: Sequence[Fault] = ()
    seed: Optional[int] = None

    @staticmethod
    def generate(
        seed: int,
        n_faults: int,
        *,
        ticks: int,
        num_slots: int,
        kinds: Sequence[str] = ("nan_membrane", "corrupt_ring",
                                "chunk_exception"),
        num_layers: int = 1,
        max_exception_times: int = 1,
    ) -> "FaultSchedule":
        """Seeded uniform schedule: ``n_faults`` draws of (tick, kind,
        slot, layer) over a ``ticks``-tick horizon.  ``chunk_exception``
        draws stay transient (``times <= max_exception_times``, no
        backend restriction) so generated schedules never exhaust the
        retry budget — targeted tests construct persistent faults
        explicitly."""
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(int(n_faults)):
            kind = kinds[int(rng.integers(len(kinds)))]
            faults.append(Fault(
                tick=int(rng.integers(ticks)),
                kind=kind,
                slot=int(rng.integers(num_slots)),
                layer=int(rng.integers(num_layers)),
                times=int(rng.integers(1, max_exception_times + 1)),
                ticks=1,
            ))
        faults.sort(key=lambda f: f.tick)
        return FaultSchedule(faults=tuple(faults), seed=seed)

    def __len__(self) -> int:
        return len(self.faults)


class FaultInjector:
    """Applies a :class:`FaultSchedule` against a live engine.

    The engine calls :meth:`begin_tick` at the top of every tick (the
    injector mutates device state/rings for due faults and arms
    exceptions/stalls), :meth:`stalled` to honor stall windows, and
    :meth:`maybe_raise` from inside each supervised dispatch attempt.
    """

    def __init__(self, schedule: FaultSchedule):
        self.schedule = schedule
        self.reset()

    def reset(self) -> None:
        self._pending: List[Fault] = sorted(
            self.schedule.faults, key=lambda f: f.tick
        )
        self._armed: List[Dict] = []  # {"remaining", "only_backend"}
        self._stall_until = -1
        self.applied: List[Dict] = []
        self.raised = 0

    # ------------------------------------------------------------ hooks
    def _injectable(self, engine, s: int) -> bool:
        # resident, mid-window, and already past its first chunk: a slot
        # admitted this tick still has its device admit flag set, and
        # the chunk's fresh-slot zeroing would erase the injected fault
        # before detection could see it.
        return (
            engine._slot_req[s] is not None
            and 0 < engine._slot_done[s] < engine._slot_total[s]
        )

    def _pick_slot(self, engine, preferred: Optional[int]) -> Optional[int]:
        if preferred is not None and self._injectable(engine, preferred):
            return preferred
        for s in range(engine.S):
            if self._injectable(engine, s):
                return s
        return None

    def begin_tick(self, engine, tick: int) -> List[Dict]:
        """Apply every fault due at ``tick`` (or carried forward from an
        earlier tick with no injectable target); returns the records of
        faults applied *now* (state/ring mutations + armed
        exceptions/stalls)."""
        applied_now: List[Dict] = []
        still_pending: List[Fault] = []
        for f in self._pending:
            if f.tick > tick:
                still_pending.append(f)
                continue
            rec = {"tick": tick, "kind": f.kind, "slot": None, "rid": None}
            if f.kind == "chunk_exception":
                self._armed.append({
                    "remaining": int(f.times),
                    "only_backend": f.only_backend,
                })
            elif f.kind == "stall":
                self._stall_until = max(self._stall_until, tick + f.ticks)
            elif f.kind == "process_kill":
                # record first (moot for us — the process is gone — but
                # a shared applied-log file would see it), then die the
                # way a preempted node dies: no atexit, no flushes
                self.applied.append(rec)
                os.kill(os.getpid(), signal.SIGKILL)
            elif f.kind == "corrupt_checkpoint":
                if f.path is None:
                    raise ValueError(
                        "corrupt_checkpoint fault needs path="
                    )
                try:
                    rec["path"] = corrupt_checkpoint(f.path)
                except FileNotFoundError:
                    still_pending.append(f)  # no save yet: carry forward
                    continue
            else:
                s = self._pick_slot(engine, f.slot)
                if s is None:
                    still_pending.append(f)  # carry forward
                    continue
                rec["slot"] = s
                rec["rid"] = engine._slot_req[s]
                if f.kind == "nan_membrane":
                    self._apply_nan_membrane(engine, s, f.layer)
                else:
                    self._apply_corrupt_ring(engine, s)
            self.applied.append(rec)
            applied_now.append(rec)
        self._pending = still_pending
        return applied_now

    def stalled(self, tick: int) -> bool:
        return tick < self._stall_until

    def maybe_raise(self, backend: str) -> None:
        """Raise one armed :class:`InjectedChunkError`, if any matches
        the dispatching backend.  Called once per dispatch attempt —
        each call consumes at most one armed raise, so ``times=n``
        poisons n attempts."""
        for arm in self._armed:
            if arm["remaining"] <= 0:
                continue
            if arm["only_backend"] not in (None, backend):
                continue
            arm["remaining"] -= 1
            self.raised += 1
            raise InjectedChunkError(
                f"injected chunk fault (backend={backend!r}, "
                f"{arm['remaining']} raises left)"
            )

    # ----------------------------------------------------- applications
    @staticmethod
    def _apply_nan_membrane(engine, s: int, layer: int) -> None:
        sh, r = engine._where[s]  # the slot's shard and row in it
        layer = min(layer, len(sh._states) - 1)
        sh._states[layer].u[r, 0] = float("nan")

    @staticmethod
    def _apply_corrupt_ring(engine, s: int) -> None:
        # impossible per-step event count at the slot's next read
        # offset: the chunk window starting at ``done`` must see it
        off = int(engine._slot_done[s])
        sh, r = engine._where[s]
        sh._ring["counts"][r, off] = -7
