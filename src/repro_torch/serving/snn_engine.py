"""Streaming SNN serving engine on PyTorch: device-resident event rings,
EDF admission, one-deep pipelined ticks.

The core of ``repro.serving.snn_engine.SNNStreamEngine``:

- **submit()/poll()/drain()/run().**  Requests carry an optional relative
  ``deadline_s`` and a ``priority``; the admission heap orders them by
  (priority desc, earliest deadline first, FIFO).  ``poll`` fills free
  slots, advances every active slot by one chunk and returns what
  finished.
- **Device-resident staging.**  Admission uploads a request once: an image
  is rate-encoded on the device, and the train is packed on the device
  into a per-step event table (int16 addresses, int8 values) in the slot's
  ring, padded by ``Tc`` steps so a chunk's slice never leaves the ring.
- **The chunk.**  Each tick indexes every slot's next ``Tc`` steps out of
  its ring at the on-device ``done`` offset, masks steps past the window,
  runs ``runtime.run_chunk_events`` (the ``snn_chunk`` kernel with
  ``backend="fused"``), sets the per-slot fault bitmask, sanitizes faulted
  slots and sums per-slot stats, all on the device with no host read.
- **Pipelined stats.**  A chunk's stats are copied to pinned host memory
  behind a CUDA event as soon as they are computed; with
  ``pipeline_depth=1`` the next chunk is dispatched before they are read.
  Ticks that finish a request's window retire eagerly.
- **Measured energy.**  A request's energy is priced from the events it
  generated (``core.energy.snn_ops_from_events``).

Entry points run on the card: ``device=None`` means ``cuda`` and raises
when no GPU is present; pass ``device="cpu"`` explicitly to run on the CPU.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import coding, energy, neuron, snn
from repro_torch.events import aer, runtime
from repro_torch.events import capacity as cap_mod

# chunk fault bitmask (device-side detection -> host quarantine codes)
FAULT_NONFINITE_STATE = 1
FAULT_RING_CORRUPT = 2
FAULT_CAPACITY_OVERFLOW = 4
_FAULT_NAMES = {
    FAULT_NONFINITE_STATE: "nonfinite_state",
    FAULT_RING_CORRUPT: "ring_corrupt",
    FAULT_CAPACITY_OVERFLOW: "capacity_overflow",
}


def fault_code_names(code: int) -> str:
    """Human-readable ``+``-joined names of a chunk fault bitmask."""
    names = [n for bit, n in sorted(_FAULT_NAMES.items()) if code & bit]
    return "+".join(names) if names else f"unknown({code})"


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises rather than falling back to the
    CPU when no GPU is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU explicitly"
        )
    return dev


class EngineStallError(RuntimeError):
    """``drain(timeout_s=...)`` expired with the engine not idle;
    ``results`` holds whatever completed before the stall."""

    def __init__(self, message: str, results):
        super().__init__(message)
        self.results = list(results)


@dataclasses.dataclass
class StreamRequest:
    """One inference over a spike stream.

    Provide either ``image`` ((K,) floats in [0,1], rate-encoded on the
    device at admission) or ``spikes`` ((T, K) integer-valued spike
    magnitudes in [-127, 127], staged as an int8 event table).
    ``deadline_s`` is relative to submission; higher ``priority`` admits
    sooner, then earliest deadline, then FIFO.
    """

    image: Optional[np.ndarray] = None
    spikes: Optional[np.ndarray] = None
    num_steps: Optional[int] = None  # None -> cfg.num_steps (must be >= 1)
    deadline_s: Optional[float] = None
    priority: int = 0


@dataclasses.dataclass
class StreamResult:
    request_id: int
    prediction: int
    spike_counts: np.ndarray  # (n_class,) output spike counts
    steps: int
    latency_s: float  # submit -> finish (includes queue wait)
    queue_wait_s: float  # submit -> admission into a slot
    events_per_layer: np.ndarray  # (n_layers,) measured input events
    spike_rate: float  # measured mean input rate of layer 0
    energy_pj: float  # priced from measured events
    deadline_s: Optional[float] = None
    deadline_missed: bool = False
    # "ok" (served) or "quarantined" (poisoned mid-flight; ``fault`` names
    # the fault codes and the stats are discarded)
    disposition: str = "ok"
    fault: Optional[str] = None


class SNNStreamEngine:
    """EDF scheduler over device-resident event rings and the chunk
    runtime."""

    def __init__(
        self,
        params: Dict[str, Dict[str, torch.Tensor]],
        cfg: snn.SNNConfig,
        *,
        num_slots: int = 8,
        chunk_steps: int = 5,
        seed: int = 0,
        backend: str = "auto",
        capacities: Optional[Sequence[int]] = None,
        pipeline_depth: int = 1,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.S = num_slots
        self.Tc = chunk_steps
        if backend == "auto":
            backend = "fused" if self.device.type == "cuda" else "torch"
        if backend not in ("torch", "fused", "fused_ref"):
            raise ValueError(f"unknown engine backend {backend!r}")
        self.backend = backend
        self.pipeline_depth = max(0, int(pipeline_depth))
        self.capacities = (
            tuple(int(c) for c in capacities) if capacities is not None else None
        )
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.params = {
            name: {k: v.to(self.device) for k, v in lp.items()}
            for name, lp in params.items()
        }
        # prepare (fake-quantize) once, never per chunk
        self._prepared = runtime.prepare_params(self.params, cfg)
        self.C = cap_mod.input_capacity(cfg, self.capacities)
        self._addr_dtype = aer.addr_dtype_for(cfg.layer_sizes[0])
        self._ring_steps = max(int(cfg.num_steps), chunk_steps)
        self._step_ids = torch.arange(chunk_steps, device=self.device)
        self._slot_ids = torch.arange(num_slots, device=self.device)
        self._lane_ids = torch.arange(self.C, device=self.device)
        self._reset_all()

    # ------------------------------------------------------------- state
    def _reset_all(self) -> None:
        cfg, S, dev = self.cfg, self.S, self.device
        self._states = runtime.init_states(cfg, S, device=dev)
        self._ring = self._alloc_ring(self._ring_steps)
        self._meta = {
            k: torch.zeros((S,), dtype=torch.int32, device=dev)
            for k in ("done", "total", "admit", "fault")
        }
        self._slot_req: List[Optional[int]] = [None] * S
        self._slot_done = np.zeros(S, np.int64)  # steps dispatched
        self._slot_retired = np.zeros(S, np.int64)  # steps stats-retired
        self._slot_total = np.zeros(S, np.int64)
        self._slot_submit_t = np.zeros(S, np.float64)
        self._slot_admit_t = np.zeros(S, np.float64)
        self._slot_deadline: List[Optional[float]] = [None] * S
        self._slot_rel_deadline: List[Optional[float]] = [None] * S
        self._slot_counts = np.zeros((S, cfg.layer_sizes[-1]), np.float64)
        self._slot_memsum = np.zeros((S, cfg.layer_sizes[-1]), np.float64)
        self._slot_events = np.zeros((S, cfg.num_layers), np.float64)
        # one-deep stats pipeline: (host stats, ready event, take, rids)
        self._inflight: "collections.deque[Tuple]" = collections.deque()
        self._queue: List[tuple] = []  # heap: (key, rid, req, t_sub, dl)
        self._pending_results: List[StreamResult] = []
        self.fault_events: List[Dict] = []
        self._seq = 0
        self._next_rid = 0
        self._episode_open = False
        self._episode_t0 = 0.0
        self.dispatched_ticks = 0  # lifetime chunk dispatches
        self._reset_episode_counters()

    def _reset_episode_counters(self) -> None:
        self.total_events = 0.0
        self.total_steps = 0
        self.completed = 0
        self.deadline_misses = 0
        self.wall_s = 0.0
        self._quarantined_events = 0.0

    def _alloc_ring(self, ring_steps: int) -> Dict[str, torch.Tensor]:
        # Tc steps of zero padding keep every chunk slice inside the ring
        # at every done offset in [0, ring_steps]
        S, C, dev = self.S, self.C, self.device
        R = ring_steps + self.Tc
        return {
            "addrs": torch.zeros((S, R, C), dtype=self._addr_dtype, device=dev),
            "values": torch.zeros((S, R, C), dtype=torch.int8, device=dev),
            "counts": torch.zeros((S, R), dtype=torch.int32, device=dev),
        }

    def _grow_ring(self, T: int) -> None:
        """Grow the rings to hold a T-step train; other slots' staged
        trains survive."""
        old, r_old = self._ring, self._ring_steps + self.Tc
        self._ring_steps = int(T)
        self._ring = self._alloc_ring(self._ring_steps)
        for k, buf in self._ring.items():
            buf[:, :r_old] = old[k]

    # --------------------------------------------------------- admission
    def _resolve_steps(self, req: StreamRequest) -> int:
        T = self.cfg.num_steps if req.num_steps is None else int(req.num_steps)
        if T < 1:
            raise ValueError(f"num_steps must be >= 1, got {req.num_steps}")
        return T

    def submit(self, req: StreamRequest) -> int:
        """Enqueue one request; returns its request id.  Admission happens
        at the next ``poll()``."""
        T = self._resolve_steps(req)
        K = self.cfg.layer_sizes[0]
        if req.spikes is not None:
            shape = tuple(np.shape(req.spikes))
            if shape != (T, K):
                raise ValueError(f"request spikes shape {shape} != ({T}, {K})")
            s = np.asarray(req.spikes)
            if not np.all(np.isfinite(s)):
                raise ValueError(
                    "request spikes contain NaN/inf — non-finite trains "
                    "are rejected at the admission boundary"
                )
            if not np.all((s == np.round(s)) & (np.abs(s) <= 127)):
                raise ValueError(
                    "request spikes must be integer-valued magnitudes in "
                    "[-127, 127] — the train is staged as an int8 AER "
                    "event table"
                )
        elif req.image is not None:
            shape = tuple(np.shape(req.image))
            if shape != (K,):
                raise ValueError(f"request image shape {shape} != ({K},)")
            if not np.all(np.isfinite(np.asarray(req.image))):
                raise ValueError(
                    "request image contains NaN/inf — non-finite images "
                    "are rejected at the admission boundary"
                )
        else:
            raise ValueError("StreamRequest needs image or spikes")
        now = time.perf_counter()
        if not self._episode_open:
            self._reset_episode_counters()
            self._episode_t0 = now
            self._episode_open = True
        rid = self._next_rid
        self._next_rid += 1
        dl = now + req.deadline_s if req.deadline_s is not None else None
        key = (
            -int(req.priority),
            0 if dl is not None else 1,  # deadline-less requests last
            dl if dl is not None else 0.0,
            self._seq,  # FIFO tiebreak
        )
        self._seq += 1
        heapq.heappush(self._queue, (key, rid, req, now, dl))
        return rid

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """One host->device copy of a float32 array; from pinned memory
        on the card, so it does not wait for chunks in flight."""
        t = torch.from_numpy(np.array(arr, dtype=np.float32))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _admit(
        self,
        s: int,
        rid: int,
        req: StreamRequest,
        t_submit: float,
        abs_deadline: Optional[float],
    ) -> None:
        T = self._resolve_steps(req)
        if T > self._ring_steps:
            self._grow_ring(T)
        if req.spikes is not None:
            train = self._upload(req.spikes)
        else:
            train = coding.rate_encode(self._gen, self._upload(req.image), T)
        self._stage(s, train)
        self._slot_req[s] = rid
        self._slot_done[s] = 0
        self._slot_retired[s] = 0
        self._slot_total[s] = T
        self._slot_submit_t[s] = t_submit
        self._slot_admit_t[s] = time.perf_counter()
        self._slot_deadline[s] = abs_deadline
        self._slot_rel_deadline[s] = req.deadline_s
        self._slot_counts[s] = 0.0
        self._slot_memsum[s] = 0.0
        self._slot_events[s] = 0.0

    def _stage(self, s: int, train: torch.Tensor) -> None:
        """Pack ``train`` (T, K) into slot ``s``'s ring and reset its
        device metadata, without a host read."""
        T = train.shape[0]
        table = runtime.encode_step_table(
            train, self.C, addr_dtype=self._addr_dtype
        )
        self._ring["addrs"][s, :T] = table.addrs
        self._ring["values"][s, :T] = table.values
        self._ring["counts"][s, :T] = table.counts
        meta = self._meta
        meta["done"][s] = 0
        meta["total"][s] = T
        meta["admit"][s] = 1
        # a step with more nonzero inputs than C would be truncated
        # silently by the packed table: flag it for quarantine
        over = torch.any(torch.sum(train != 0, dim=-1) > self.C)
        meta["fault"][s] = over.to(torch.int32) * FAULT_CAPACITY_OVERFLOW

    # ------------------------------------------------------------- chunk
    def _chunk(self, states, meta):
        """One tick on the device: returns (new_states, new_meta, stats)."""
        cfg, Tc, C = self.cfg, self.Tc, self.C
        ring = self._ring
        done, total, admit = meta["done"], meta["total"], meta["admit"]
        take = torch.clamp(total - done, 0, Tc)
        act = (take > 0).to(torch.float32)
        # slots admitted since the previous chunk start from zero state
        fresh = admit[:, None] > 0
        states = [
            neuron.NeuronState(
                u=torch.where(fresh, 0.0, st.u),
                refrac=torch.where(fresh, 0, st.refrac),
            )
            for st in states
        ]
        # each slot's next Tc steps out of its ring, slot-major (S, Tc, C)
        rows = self._slot_ids[:, None]
        steps = done[:, None].long() + self._step_ids[None, :]
        a_c = ring["addrs"][rows, steps]
        v_c = ring["values"][rows, steps]
        c_c = ring["counts"][rows, steps]
        # silence steps past the request's window: there the ring holds a
        # previous occupant's stale events
        in_window = self._step_ids[None, :] < take[:, None]
        values = torch.where(in_window[:, :, None], v_c, 0)
        counts = torch.where(in_window, c_c, 0)
        new_states, out_mem, out_spikes, events = runtime.run_chunk_events(
            self._prepared, states, a_c, values, counts, cfg,
            active=act, capacities=self.capacities, prepared=True,
            backend=self.backend, layout="slot_major",
        )
        # per-slot fault bitmask, masked to the request's own window;
        # faulted slots are zeroed here so they never contaminate a later
        # occupant (a bit-exact no-op for clean slots)
        bad_state = torch.zeros_like(in_window[:, 0])
        for st in new_states:
            bad_state = bad_state | ~torch.isfinite(st.u).all(dim=-1)
        bad_count = ((counts < 0) | (counts > C)).any(dim=-1)
        ev_valid = in_window[:, :, None] & (
            self._lane_ids[None, None, :]
            < torch.clamp(counts, 0, C)[:, :, None]
        )
        a32 = a_c.to(torch.int32)
        bad_addr = (
            (ev_valid & ((a32 < 0) | (a32 >= cfg.layer_sizes[0])))
            .flatten(1)
            .any(dim=1)
        )
        fault = (
            meta["fault"]
            | bad_state.to(torch.int32) * FAULT_NONFINITE_STATE
            | (bad_count | bad_addr).to(torch.int32) * FAULT_RING_CORRUPT
        )
        poisoned = (fault > 0)[:, None]
        new_states = [
            neuron.NeuronState(
                u=torch.where(poisoned, 0.0, st.u),
                refrac=torch.where(poisoned, 0, st.refrac),
            )
            for st in new_states
        ]
        # per-slot stats over the request's own steps only
        m = (self._step_ids[:, None] < take[None, :]).to(torch.float32)
        stats = torch.cat([
            torch.sum(out_spikes * m[:, :, None], dim=0).flatten(),
            torch.sum(out_mem * m[:, :, None], dim=0).flatten(),
            torch.sum(events * m[:, None, :], dim=0).T.flatten(),
            fault.to(torch.float32),
        ])
        new_meta = {
            "done": done + take,
            "total": total,
            "admit": torch.zeros_like(admit),
            # staged fault bits report exactly once, then clear
            "fault": torch.zeros_like(fault),
        }
        return new_states, new_meta, stats

    def _dispatch_chunk(self, take: np.ndarray) -> None:
        self._states, self._meta, stats = self._chunk(self._states, self._meta)
        ready = None
        if self.device.type == "cuda":
            # start the stats' trip to the host now, so reading them later
            # waits for this chunk only, not for chunks dispatched after it
            host = torch.empty(stats.shape, dtype=stats.dtype, pin_memory=True)
            host.copy_(stats, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            stats = host
        self._inflight.append((stats, ready, take.copy(), list(self._slot_req)))
        self.dispatched_ticks += 1

    # -------------------------------------------------------------- tick
    def _tick(self) -> List[int]:
        """Dispatch the next chunk (if any slot has steps left) and retire
        pipelined stats; returns the slots whose requests finished."""
        S, Tc = self.S, self.Tc
        take = np.zeros(S, np.int32)
        for s in range(S):
            if self._slot_req[s] is not None:
                take[s] = min(Tc, int(self._slot_total[s] - self._slot_done[s]))
        dispatched = bool(take.sum() > 0)
        if dispatched:
            self._dispatch_chunk(take)
            self._slot_done += take
        # keep at most pipeline_depth chunks in flight; retire one anyway
        # when nothing was dispatched, and drain eagerly when a request's
        # final chunk is in flight
        finishing = any(
            self._slot_req[s] is not None
            and self._slot_done[s] >= self._slot_total[s]
            and self._slot_retired[s] < self._slot_total[s]
            for s in range(S)
        )
        force = 0 if dispatched else min(1, len(self._inflight))
        finished: List[int] = []
        while self._inflight and (
            len(self._inflight) > self.pipeline_depth or force or finishing
        ):
            force = 0
            finished.extend(self._retire())
        return finished

    def _retire(self) -> List[int]:
        """Read the oldest in-flight chunk's stats and fold them into the
        per-slot accumulators."""
        stats, ready, take, rids = self._inflight.popleft()
        if ready is not None:
            ready.synchronize()
        flat = stats.numpy()
        S, NL, L = self.S, self.cfg.layer_sizes[-1], self.cfg.num_layers
        counts = flat[: S * NL].reshape(S, NL)
        memsum = flat[S * NL : 2 * S * NL].reshape(S, NL)
        events = flat[2 * S * NL : 2 * S * NL + S * L].reshape(S, L)
        fault = flat[2 * S * NL + S * L :].astype(np.int64)
        finished = []
        for s in range(S):
            if rids[s] is None or take[s] == 0:
                continue
            if self._slot_req[s] != rids[s]:
                continue  # slot was freed and re-admitted since dispatch
            if fault[s] != 0:
                self._quarantine(s, int(fault[s]))
                continue
            self._slot_counts[s] += counts[s]
            self._slot_memsum[s] += memsum[s]
            self._slot_events[s] += events[s]
            self._slot_retired[s] += int(take[s])
            self.total_events += float(events[s].sum())
            self.total_steps += int(take[s])
            if self._slot_retired[s] >= self._slot_total[s]:
                finished.append(s)
        return finished

    def _quarantine(self, s: int, code: int) -> None:
        """Fail slot ``s``'s request into a quarantined result and free the
        slot; its folded work leaves the throughput numerator."""
        rid = self._slot_req[s]
        names = fault_code_names(code)
        now = time.perf_counter()
        self._quarantined_events += float(self._slot_events[s].sum())
        self.fault_events.append(
            {"slot": s, "rid": rid, "code": code, "fault": names}
        )
        self._pending_results.append(StreamResult(
            request_id=rid,
            prediction=-1,
            spike_counts=np.zeros(self.cfg.layer_sizes[-1]),
            steps=int(self._slot_total[s]),
            latency_s=now - self._slot_submit_t[s],
            queue_wait_s=self._slot_admit_t[s] - self._slot_submit_t[s],
            events_per_layer=np.zeros(self.cfg.num_layers),
            spike_rate=0.0,
            energy_pj=0.0,
            deadline_s=self._slot_rel_deadline[s],
            deadline_missed=False,
            disposition="quarantined",
            fault=names,
        ))
        self._slot_req[s] = None

    def _finalize(self, s: int) -> StreamResult:
        cfg = self.cfg
        T = int(self._slot_total[s])
        ev = self._slot_events[s].copy()
        oc = energy.snn_ops_from_events(
            cfg.layer_sizes, T, ev, neuron_kind=cfg.neuron_kind
        )
        counts = self._slot_counts[s]
        pred = int(np.argmax(counts + 1e-6 * self._slot_memsum[s]))
        finish_t = time.perf_counter()
        dl = self._slot_deadline[s]
        missed = dl is not None and finish_t > dl
        self.completed += 1
        if missed:
            self.deadline_misses += 1
        res = StreamResult(
            request_id=self._slot_req[s],
            prediction=pred,
            spike_counts=counts.copy(),
            steps=T,
            latency_s=finish_t - self._slot_submit_t[s],
            queue_wait_s=self._slot_admit_t[s] - self._slot_submit_t[s],
            events_per_layer=ev,
            spike_rate=float(ev[0] / (T * cfg.layer_sizes[0])),
            energy_pj=oc.energy_pj(),
            deadline_s=self._slot_rel_deadline[s],
            deadline_missed=missed,
        )
        self._slot_req[s] = None
        return res

    # --------------------------------------------------------- scheduler
    def idle(self) -> bool:
        """True when nothing is queued, resident, in flight or
        undelivered."""
        return (
            not self._queue
            and all(r is None for r in self._slot_req)
            and not self._inflight
            and not self._pending_results
        )

    def _close_episode_if_idle(self) -> None:
        if self.idle() and self._episode_open:
            self.wall_s = time.perf_counter() - self._episode_t0
            self._episode_open = False

    def poll(self) -> List[StreamResult]:
        """One scheduler round: admit queued requests into free slots,
        dispatch the next chunk, retire pipelined stats, and return the
        requests that finished (quarantined ones included)."""
        for s in range(self.S):
            if self._slot_req[s] is None and self._queue:
                _, rid, req, t_sub, dl = heapq.heappop(self._queue)
                self._admit(s, rid, req, t_sub, dl)
        if all(r is None for r in self._slot_req) and not self._inflight:
            results, self._pending_results = self._pending_results, []
            self._close_episode_if_idle()
            return results
        results = [self._finalize(s) for s in self._tick()]
        if self._pending_results:
            results = self._pending_results + results
            self._pending_results = []
        self._close_episode_if_idle()
        return results

    def drain(self, timeout_s: Optional[float] = None) -> List[StreamResult]:
        """Poll until idle; returns results in completion order.  Raises
        ``EngineStallError`` if ``timeout_s`` expires first."""
        results: List[StreamResult] = []
        t0 = time.perf_counter()
        while not self.idle():
            results.extend(self.poll())
            if (
                timeout_s is not None
                and time.perf_counter() - t0 > timeout_s
                and not self.idle()
            ):
                raise EngineStallError(
                    f"drain() timed out after {timeout_s}s with the engine "
                    f"not idle: queue={len(self._queue)} "
                    f"inflight={len(self._inflight)} "
                    f"slots={self._slot_req}",
                    results,
                )
        return results

    def run(self, requests: List[StreamRequest]) -> List[StreamResult]:
        """Serve all requests; results sorted by request id."""
        for req in requests:
            self.submit(req)
        results = self.drain()
        results.sort(key=lambda r: r.request_id)
        return results

    # ------------------------------------------------------------- stats
    def events_per_sec(self) -> float:
        """Event throughput of the serving episode (quarantined work
        excluded); the denominator is the episode clock."""
        if self._episode_open:
            denom = time.perf_counter() - self._episode_t0
        else:
            denom = self.wall_s
        ev = self.total_events - self._quarantined_events
        return max(ev, 0.0) / max(denom, 1e-9)

    def deadline_miss_rate(self) -> float:
        """Fraction of this episode's ok completions that missed their
        deadline (requests without a deadline count as met)."""
        return self.deadline_misses / max(self.completed, 1)
