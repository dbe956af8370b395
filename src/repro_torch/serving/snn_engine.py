"""Streaming SNN serving engine on PyTorch: device-resident event rings,
EDF admission, a tick replayed as one CUDA graph over static buffers,
pipelined stats, and the reference engine's instruments.

The core of ``repro.serving.snn_engine.SNNStreamEngine``:

- **submit()/poll()/drain()/run().**  Requests carry an optional relative
  ``deadline_s`` and a ``priority``; the admission heap orders them by
  (priority desc, earliest deadline first, FIFO).  ``poll`` fills free
  slots, advances every active slot by one chunk and returns what
  finished.
- **Device-resident staging.**  Admission uploads a request once, through
  the slot's pinned staging buffer: an image is rate-encoded on the
  device, and the train is packed on the device into a per-step event
  table (int16 addresses, int8 values) in the slot's ring, padded by
  ``Tc`` steps so a chunk's slice never leaves the ring.  ``_stage``
  writes rows ``[:T]`` of the slot and its metadata in place by index
  ops over a device slot index, never a host one.
- **Admission as CUDA graphs.**  The port's form of the reference's
  jitted admission with donated ring and metadata: on the card, with the
  tick graphed, each request kind (``spikes``, ``image``) and window ``T``
  at the current ring size is captured once into a
  ``torch.cuda.CUDAGraph`` of ``_stage`` over static inputs (the train,
  or the image and its uniforms), a static slot index and the ring and
  metadata buffers, after a warm-up on copies on a side stream, in a
  memory pool of its own (admission and tick graphs replay in no fixed
  order).  An admission copies the upload into the static input, draws
  an image's uniforms from the engine's generator outside the graph
  (so the trains equal the eager engine's bit for bit), sets the slot
  index by a device-to-device copy and replays.  ``_grow_ring`` drops the
  admission graphs; each capture of a new (kind, T, ring size) is an
  allowlisted site, any other counts in ``engine.tick.recompiles``.  A
  failed capture or replay raises; the eager staging never runs in its
  place.  ``cuda_graph=False``, the CPU and the plain backends run the
  same ``_stage`` uncaptured over the same buffers.
- **Static buffers.**  Every input and output of the chunk (per-layer
  membrane and refractory state, the scheduling metadata ``done`` /
  ``total`` / ``admit`` / ``fault``, the rings and the stats vector) is
  allocated once and updated in place; only ``_grow_ring`` allocates
  again.  This is the port's form of the reference's jitted chunk with
  donated state and metadata: a steady tick uploads nothing.
- **The chunk as a CUDA graph.**  On the card with ``backend="fused"``
  each tick replays one captured ``torch.cuda.CUDAGraph`` of ``_chunk``
  (ring slice at the on-device ``done`` offsets, window mask, the
  ``snn_chunk`` kernel, fault bitmask, sanitizing, per-slot stats),
  captured at the first dispatch after a warm-up on copies, one graph per
  ring size.  Only ring growth re-captures; any other capture counts in
  ``engine.tick.recompiles`` (``steady_state_recompiles()``).  A failed
  build, capture, launch or replay raises; the engine never runs the
  eager chunk in its place.  ``backend="torch"`` and ``"fused_ref"``
  (the plain versions, for checking) and the CPU run the same in-place
  chunk eagerly.
- **Pipelined stats.**  A chunk's stats are copied behind a CUDA event
  into one of ``pipeline_depth + 1`` pinned host buffers allocated once;
  with ``pipeline_depth=1`` the next chunk is dispatched before they are
  read.  A steady tick makes exactly one device-to-host read, in
  ``_fetch``.  Ticks that finish a request's window retire eagerly.
- **Measured energy.**  A request's energy is priced from the events it
  generated (``core.energy.snn_ops_from_events``).
- **Observability.**  ``engine.metrics`` (a ``MetricsRegistry``) holds the
  reference engine's instruments under the reference's names: episode
  counters, request histograms, tick-phase histograms
  (``engine.tick.host_prep_s`` / ``dispatch_s`` / ``stats_fetch_s``) and
  the fault, shedding, preemption and snapshot instruments.
  ``engine.trace`` records a span per request lifecycle stage (``submit``
  from entry to return) and per tick phase, at most three a tick: the
  ``dispatch`` span lists the request ids the chunk advanced;
  ``engine.timeseries`` samples the registry once a poll and once as an
  episode opens (a submit's counts land in the next poll's sample);
  ``health()`` judges the SLOs over it and its ``diagnosis`` tells
  "overloaded and shedding" from "faulty".
- **Admission plane** (``admission=`` an ``faults.AdmissionPolicy``).  A
  bounded queue sheds at ``submit()`` once full (``priority > 0`` parks
  instead, served best-effort when the heap empties), and an EDF
  feasibility check at admission-pop time sheds requests whose deadline
  is provably unmeetable at the measured tick rate: both end as
  ``StreamResult``s with ``disposition="shed"``.
- **Faults.**  With ``fault_checks=True`` (default) the chunk carries the
  fault bitmask (non-finite membranes, corrupt ring counts and
  addresses, staging capacity overflow) and zeroes a faulted slot's
  state; the request is quarantined while the other slots tick on
  bit-identically.  The flag is fixed at construction, so the graph is
  captured with the checks or without them.  Dispatch runs under a
  ``faults.ChunkSupervisor``: transient failures retry, persistent
  ``fused`` failures demote the engine to ``"torch"`` (one
  ``RuntimeWarning``, ``engine.faults.backend_demoted``; the graph is
  dropped and the plain chunk runs eagerly over the same buffers).  On
  the card only an ``InjectedChunkError`` is retried or demotes: the
  kernel is built at construction and the graph captured before the
  supervised attempt, and any other failure of the build, the capture,
  the fused chunk or the replay raises at once.  ``injector=`` a
  ``faults.FaultInjector`` drives seeded chaos from inside the tick.
- **Deadline-aware preemption** (``preempt=True``).  A strictly more
  urgent arrival with every slot busy parks the loosest resident window:
  its state rows, ring row and accumulators move to a host-side buffer
  (read after the stats pipeline drained), and it later resumes from the
  step it stopped at, written back in place through pinned buffers.
- **Crash-safe state.**  ``snapshot(path)`` writes the complete serving
  state (states, rings, metadata, host bookkeeping, queue, parked lists,
  undelivered results) through the checkpoint plane's atomic, checksummed
  ``publish_array_dir`` in the reference's format; ``restore(path)``
  copies it into the existing buffers, so an engine that has captured its
  graph keeps it.  ``snapshot_auto``/``restore_latest_snapshot`` add a
  keep-N rotation with corrupt-snapshot fallback.  A snapshot directory
  written by the reference engine restores into the port.
- **Sharded slots** (``mesh=`` a ``distributed.partitioning.Mesh``).  The
  slot axis splits over the mesh's ``slot`` rule axes (``pod``/``data``)
  into ``n`` shards of ``S/n`` consecutive slots, as the reference's
  ``shard_map`` over ``P(slot)`` does.  Each shard keeps its own buffers
  on its own device: the prepared params (one copy a distinct device),
  states, metadata, stats, ring, pinned staging, its tick graph and its
  admission graphs.  A tick replays (or runs) every shard's chunk over its
  own slots, and the shards' stats are copied section by section into one
  host buffer in global slot order, so retirement reads them as it reads
  an unsharded engine's.  The host bookkeeping (queue, slots, results) is
  global.  Mesh axes outside the slot rule hold replicas in the
  reference; here each shard is computed once, on the first device of its
  replica group.  The unsharded engine is the one-shard case of the same
  code, and keeps its buffers under their names (``engine._ring``, ...);
  a sharded engine's are ``engine._shards[i]._ring``.  Snapshots are host
  arrays in global slot order, so they restore across mesh shapes.

Entry points run on the card: ``device=None`` means ``cuda`` and raises
when no GPU is present; pass ``device="cpu"`` explicitly to run on the CPU.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import heapq
import os
import shutil
import time
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.analysis import contracts
from repro_torch.checkpoint.manager import (
    CheckpointCorruptError,
    gc_orphan_tmpdirs,
    load_array_dir,
    publish_array_dir,
)
from repro_torch.core import coding, energy, neuron, snn
from repro_torch.distributed import partitioning
from repro_torch.events import aer, runtime
from repro_torch.events import capacity as cap_mod
from repro_torch.faults import shedding as shed_mod
from repro_torch.faults.inject import InjectedChunkError
from repro_torch.faults.supervisor import ChunkSupervisor, RetryPolicy
from repro_torch.obs import MetricsRegistry, TimeSeriesSampler, TraceRecorder
from repro_torch.obs import slo as slo_mod

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


def _canonical(device) -> torch.device:
    """``device`` as its tensors report it (``cuda`` is ``cuda:<current>``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class EngineStallError(RuntimeError):
    """``drain(timeout_s=...)`` expired with the engine not idle.

    ``snapshot`` is the per-slot diagnostic state at expiry
    (``SNNStreamEngine.stall_snapshot()``); ``results`` holds whatever
    completed before the stall.
    """

    def __init__(self, message: str, snapshot: Dict, results):
        super().__init__(message)
        self.snapshot = snapshot
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
    # "ok" (served), "shed" (refused by the admission plane, never entered
    # a slot) or "quarantined" (poisoned mid-flight; the stats are
    # discarded).  ``fault`` carries the shed reason or the fault codes;
    # ``parked`` marks a priority request parked under overload and later
    # served best-effort.
    disposition: str = "ok"
    fault: Optional[str] = None
    parked: bool = False


def _doc_result(r: StreamResult) -> Dict:
    """JSON-able form of a StreamResult (snapshot manifest)."""
    return {
        "request_id": r.request_id,
        "prediction": r.prediction,
        "spike_counts": [float(x) for x in np.ravel(r.spike_counts)],
        "steps": r.steps,
        "latency_s": r.latency_s,
        "queue_wait_s": r.queue_wait_s,
        "events_per_layer": [float(x) for x in np.ravel(r.events_per_layer)],
        "spike_rate": r.spike_rate,
        "energy_pj": r.energy_pj,
        "deadline_s": r.deadline_s,
        "deadline_missed": bool(r.deadline_missed),
        "disposition": r.disposition,
        "fault": r.fault,
        "parked": bool(r.parked),
    }


def _undoc_result(d: Dict) -> StreamResult:
    return StreamResult(
        request_id=d["request_id"],
        prediction=d["prediction"],
        spike_counts=np.asarray(d["spike_counts"], np.float64),
        steps=d["steps"],
        latency_s=d["latency_s"],
        queue_wait_s=d["queue_wait_s"],
        events_per_layer=np.asarray(d["events_per_layer"], np.float64),
        spike_rate=d["spike_rate"],
        energy_pj=d["energy_pj"],
        deadline_s=d["deadline_s"],
        deadline_missed=d["deadline_missed"],
        disposition=d["disposition"],
        fault=d["fault"],
        parked=d["parked"],
    )


def _seed_from_key(key: np.ndarray) -> int:
    """A 64-bit torch seed from the words of a reference PRNG key."""
    seed = 0
    for word in np.ravel(key).astype(np.uint64):
        seed = ((seed << 32) | int(word)) % (1 << 64)
    return seed


class _SlotShard:
    """Slots ``[lo, hi)`` of an engine and what the device holds for them:
    the prepared params, the chunk's static buffers (per-layer states,
    metadata, stats, the ring), the pinned staging, the tick graph and the
    admission graphs.  A record the engine fills and reads; every buffer is
    indexed by the shard's local slot ``s - lo``."""

    def __init__(self, index: int, lo: int, hi: int, device: torch.device):
        self.index, self.lo, self.hi, self.device = index, lo, hi, device
        self.n = hi - lo
        self._prepared: Dict[str, Dict[str, torch.Tensor]] = {}
        self._states: List[neuron.NeuronState] = []
        self._meta: Dict[str, torch.Tensor] = {}
        self._stats: Optional[torch.Tensor] = None
        self._ring: Dict[str, torch.Tensor] = {}
        self._slot_ids: Optional[torch.Tensor] = None  # local ids 0..n-1
        self._pinned: List[torch.Tensor] = []
        self._pinned_ready: List[torch.cuda.Event] = []
        self._graph = None
        # (kind, T) -> the admission graph at this ring size and its
        # static inputs (``_capture_admit``)
        self._admit_graphs: Dict[Tuple[str, int], Dict] = {}


def _one_shard(name: str, doc: str) -> property:
    """An engine attribute that is its one shard's ``name``: the unsharded
    engine's buffers and graphs under the names they always had.  On a
    sharded engine they are per shard (``engine._shards[i].<name>``), and
    reading them through the engine raises."""

    def shard(self) -> _SlotShard:
        if len(self._shards) != 1:
            raise AttributeError(
                f"{name} is per shard on an engine of {len(self._shards)} "
                f"slot shards: read engine._shards[i].{name}"
            )
        return self._shards[0]

    return property(lambda self: getattr(shard(self), name),
                    lambda self, value: setattr(shard(self), name, value),
                    doc=doc)


def _on(device: torch.device):
    """The device's context for work queued on a shard (its current
    stream); nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class SNNStreamEngine:
    """EDF scheduler over device-resident event rings and the chunk
    runtime.

    ``cuda_graph=False`` runs the fused chunk eagerly on the card, launch
    by launch, as the measurement baseline beside the graph; it changes
    nothing on the CPU or for the plain-version backends, which always
    run eagerly.  ``admission``, ``fault_checks``, ``injector``, ``retry``
    and ``preempt`` are the reference engine's fault-tolerance knobs (see
    the module docstring).  ``mesh`` shards the slots (see the module
    docstring); with a mesh, ``device=None`` means the mesh's first
    device.
    """

    # the unsharded engine's buffers and graphs, under their old names
    _prepared = _one_shard("_prepared", "The prepared params.")
    _states = _one_shard("_states", "Per-layer membrane/refractory state.")
    _meta = _one_shard("_meta", "done / total / admit / fault per slot.")
    _stats = _one_shard("_stats", "The chunk's per-slot stats vector.")
    _ring = _one_shard("_ring", "The per-slot event rings.")
    _graph = _one_shard("_graph", "The tick's CUDA graph, or None.")
    _admit_graphs = _one_shard("_admit_graphs", "(kind, T) -> admission graph.")

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
        trace_capacity: int = 8192,
        timeseries_capacity: int = 4096,
        slos: Optional[Sequence] = None,
        cuda_graph: bool = True,
        admission: Optional[shed_mod.AdmissionPolicy] = None,
        fault_checks: bool = True,
        injector=None,
        retry: Optional[RetryPolicy] = None,
        preempt: bool = False,
        device=None,
        mesh: Optional[partitioning.Mesh] = None,
    ):
        if mesh is not None and device is None:
            device = mesh.devices.flat[0]
        self.device = resolve_device(device)
        self.mesh = mesh
        # (lo, hi, device) of each slot shard; raises ValueError naming
        # num_slots when the slots do not divide over the mesh's slot axes
        blocks = (
            [(0, num_slots, self.device)] if mesh is None
            else partitioning.slot_shards(num_slots, mesh)
        )
        for _, _, d in blocks:
            if resolve_device(d).type != self.device.type:
                raise ValueError(
                    f"mesh device {d} is not of the engine's device type "
                    f"{self.device.type!r}"
                )
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
        self.slos = (
            tuple(slos) if slos is not None else slo_mod.default_slos()
        )
        self._make_instruments(trace_capacity, timeseries_capacity)
        # fault-tolerance plane: admission policy (None admits everything),
        # the chunk's fault checks, the retry/demotion supervisor, an
        # optional seeded fault injector, and opt-in preemption
        self.admission = admission
        self.fault_checks = bool(fault_checks)
        self.injector = injector
        self.preempt = bool(preempt)
        self._snap_index = 0  # snapshot_auto rotation counter
        # on the card a real failure of the kernel or the replay is never
        # retried or demoted to the plain chunk: only injected faults are
        self._supervisor = ChunkSupervisor(
            retry or RetryPolicy(),
            on_retry=lambda n: self._m_retries.inc(n),
            on_demote=lambda: self._m_demoted.inc(),
            retry_on=(
                (InjectedChunkError,) if self.device.type == "cuda"
                else (Exception,)
            ),
        )
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed)
        self.params = {
            name: {k: v.to(self.device) for k, v in lp.items()}
            for name, lp in params.items()
        }
        self.C = cap_mod.input_capacity(cfg, self.capacities)
        self._addr_dtype = aer.addr_dtype_for(cfg.layer_sizes[0])
        self._ring_steps = max(int(cfg.num_steps), chunk_steps)
        # the chunk's index constants on each device that holds a shard:
        # slot ids 0..S-1 (a shard reads the first n), step ids, lane ids;
        # keyed by the device as its tensors report it
        home = _canonical(self.device)
        self._consts: Dict[torch.device, Tuple[torch.Tensor, ...]] = {}
        for d in [home] + [_canonical(d) for _, _, d in blocks]:
            if d not in self._consts:
                self._consts[d] = (
                    torch.arange(num_slots, device=d),
                    torch.arange(chunk_steps, device=d),
                    torch.arange(self.C, device=d),
                )
        self._slot_ids = self._consts[home][0]
        # prepare (fake-quantize) once, never per chunk; one copy a device
        prepared = runtime.prepare_params(self.params, cfg)
        by_device = {home: prepared}
        self._shards: List[_SlotShard] = []
        for i, (lo, hi, d) in enumerate(blocks):
            sh = _SlotShard(i, lo, hi, _canonical(d))
            if sh.device not in by_device:
                by_device[sh.device] = {
                    name: {k: v.to(sh.device) for k, v in lp.items()}
                    for name, lp in prepared.items()
                }
            sh._prepared = by_device[sh.device]
            sh._slot_ids = self._consts[sh.device][0][:sh.n]
            self._shards.append(sh)
        # global slot -> (its shard, its row in the shard's buffers)
        self._where = [(sh, s - sh.lo) for sh in self._shards
                       for s in range(sh.lo, sh.hi)]
        # the tick as a CUDA graph: fused kernel on the card only
        self.graphed = (
            bool(cuda_graph) and self.device.type == "cuda"
            and backend == "fused"
        )
        if self.device.type == "cuda" and backend == "fused":
            # build the kernel now, outside every supervised attempt: a
            # failed build raises here
            from repro_torch.kernels import _build

            _build.load("snn_chunk")
        self.graph_captures = 0  # lifetime captures (every shard's)
        self.graph_replays = 0  # lifetime replays (a shard's graph each)
        self.graph_launches_per_replay = 0  # kernel launches in a graph
        # capture-site allowlist: each shard's cold-start capture;
        # _grow_ring bumps it by one a shard (a new ring is new graph
        # inputs)
        self._captures_expected = len(self._shards)
        self._captures_accounted = 0
        self.admit_captures = 0  # lifetime admission graph captures
        self.admit_replays = 0  # lifetime admission graph replays
        # the admission graphs' allowlist: one capture per (shard, kind, T,
        # ring steps) ever seen; a second capture of one is a re-capture
        self._admit_signatures: set = set()
        self.dispatched_ticks = 0  # lifetime chunk dispatches
        self._alloc_buffers()
        self._reset_host()

    # ----------------------------------------------------- observability
    def _make_instruments(
        self, trace_capacity: int, timeseries_capacity: int
    ) -> None:
        """The metrics registry, span recorder and windowed time-series
        sampler, with the reference engine's instrument names.

        Episode-scoped counters live under ``engine.episode.`` and reset
        when an episode opens (first submit on an idle engine); request
        and tick-phase histograms are engine-lifetime (``reset_tick_stats``
        zeroes the latter).  The sampler captures a registry delta on
        every poll and as an episode opens, the signal ``health()``
        evaluates the SLOs against.
        """
        self.metrics = MetricsRegistry()
        self.trace = TraceRecorder(capacity=trace_capacity)
        m = self.metrics
        # episode-scoped (reset at _begin_episode)
        self._m_events = m.counter("engine.episode.events")
        self._m_steps = m.counter("engine.episode.steps")
        self._m_completed = m.counter("engine.episode.completed")
        self._m_misses = m.counter("engine.episode.deadline_misses")
        self._m_wall = m.gauge("engine.episode.wall_s")
        # engine-lifetime request instruments
        self._m_submitted = m.counter("engine.requests.submitted")
        self._m_finished = m.counter("engine.requests.completed")
        self._m_missed_total = m.counter("engine.requests.deadline_missed")
        self._m_latency = m.histogram(
            "engine.request.latency_s", lo=1e-6, hi=1e3
        )
        self._m_qwait = m.histogram(
            "engine.request.queue_wait_s", lo=1e-6, hi=1e3
        )
        self._m_energy = m.histogram(
            "engine.request.energy_pj", lo=1.0, hi=1e12
        )
        # tick-phase timing (reset via reset_tick_stats)
        self._m_prep = m.histogram("engine.tick.host_prep_s", lo=1e-7, hi=10.0)
        self._m_dispatch = m.histogram(
            "engine.tick.dispatch_s", lo=1e-7, hi=10.0
        )
        self._m_fetch = m.histogram(
            "engine.tick.stats_fetch_s", lo=1e-7, hi=10.0
        )
        self._m_qdepth = m.gauge("engine.queue.depth")
        self._m_active = m.gauge("engine.slots.active")
        # fault-tolerance instruments
        self._m_shed = m.counter("engine.requests.shed")
        self._m_parked_total = m.counter("engine.requests.parked")
        self._m_quarantined = m.counter("engine.requests.quarantined")
        self._m_retries = m.counter("engine.faults.chunk_retries")
        self._m_demoted = m.counter("engine.faults.backend_demoted")
        self._m_injected = m.counter("engine.faults.injected")
        # steady-state re-captures: graph captures beyond the allowlisted
        # sites (cold start, ring growth); any increment means a dispatch
        # path that is not static
        self._m_recompiles = m.counter("engine.tick.recompiles")
        self._m_q_events = m.counter("engine.episode.quarantined_events")
        self._m_q_steps = m.counter("engine.episode.quarantined_steps")
        self._m_parked_depth = m.gauge("engine.queue.parked")
        # crash-safety + preemption plane
        self._m_snap_time = m.histogram(
            "engine.snapshot.save_s", lo=1e-6, hi=100.0
        )
        self._m_restore_snap_time = m.histogram(
            "engine.snapshot.restore_s", lo=1e-6, hi=100.0
        )
        self._m_ckpt_fallback = m.counter("engine.faults.checkpoint_fallback")
        self._m_preempt_parked = m.counter("engine.preempt.parked")
        self._m_preempt_resumed = m.counter("engine.preempt.resumed")
        self._m_preempt_events = m.counter("engine.preempt.parked_events")
        self._m_preempt_depth = m.gauge("engine.preempt.buffer_depth")
        self._m_park_time = m.histogram(
            "engine.preempt.park_s", lo=1e-7, hi=10.0
        )
        self._m_restore_time = m.histogram(
            "engine.preempt.restore_s", lo=1e-7, hi=10.0
        )
        # SLO verdict gauge (0 healthy / 1 degraded / 2 breach)
        self._m_health = m.gauge("engine.slo.status")
        self.timeseries = TimeSeriesSampler(
            self.metrics,
            capacity=timeseries_capacity,
            track_buckets=("engine.request.latency_s",),
        )

    def metrics_snapshot(self) -> Dict[str, Dict]:
        """JSON-able snapshot of every engine instrument."""
        return self.metrics.snapshot()

    def export_trace(self, path) -> None:
        """Write the recorded spans as Chrome trace-event JSON
        (Perfetto-loadable)."""
        self.trace.write(path)

    def health(self) -> Dict:
        """Evaluate the engine's SLOs (multi-window burn rates over the
        time-series sampler) and publish the verdict as the
        ``engine.slo.status`` gauge.  ``status`` is ``healthy`` /
        ``degraded`` / ``breach``; ``slos`` carries per-SLO windowed error
        rates and per-rule burn rates; ``diagnosis`` says why."""
        report = slo_mod.evaluate(self.slos, self.timeseries)
        self._m_health.set(report["status_code"])
        report["diagnosis"] = self._diagnose(report)
        return report

    def _diagnose(self, report: Dict) -> Dict:
        """Separate *why* the SLO verdict is what it is: ``faulty``
        (quarantines, demotions or retries happened), ``overloaded`` (SLOs
        unhappy while the admission plane sheds), ``breaching`` (SLOs
        unhappy with no shedding and no faults) or ``nominal``."""
        quarantined = self._m_quarantined.value
        demoted = self._m_demoted.value
        retries = self._m_retries.value
        shed = self._m_shed.value
        recompiles = int(self._m_recompiles.value)
        window = self.timeseries.ratio(
            "engine.requests.shed", "engine.requests.submitted", 10.0
        )
        unhappy = report["status"] != "healthy"
        if quarantined > 0 or demoted > 0 or retries > 0:
            verdict = "faulty"
            hint = (
                "fault path active (quarantines/demotions/retries): "
                "inspect fault_events and engine.faults.* counters "
                "before scaling anything"
            )
        elif unhappy and shed > 0:
            verdict = "overloaded"
            hint = (
                "SLO pressure with active load shedding: the admission "
                "plane is degrading correctly — add capacity (slots/"
                "hosts) or lower the offered rate"
            )
        elif unhappy:
            verdict = "breaching"
            hint = (
                "SLO pressure with no shedding and no faults: deadlines "
                "exceed serving capacity — enable an AdmissionPolicy or "
                "relax deadline targets"
            )
        else:
            verdict = "nominal"
            hint = "no action needed"
        if recompiles > 0:
            hint += (
                "; WARNING: steady-state graph re-captures observed "
                f"({recompiles}, chunk or admission) — a dispatch path is "
                "not static (every capture stalls serving for a device "
                "sync)"
            )
        park_rate = self.timeseries.rate("engine.preempt.parked", 10.0)
        done_rate = self.timeseries.rate("engine.requests.completed", 10.0)
        thrash = park_rate > 0.0 and park_rate > done_rate
        if thrash:
            hint += (
                "; preempt_thrash: park/restore rate exceeds the "
                "completion rate"
            )
        return {
            "verdict": verdict,
            "hint": hint,
            "recompiling": recompiles > 0,
            "steady_state_recompiles": recompiles,
            "shed_total": shed,
            "windowed_shed_rate": window,
            "parked_depth": len(self._parked),
            "preempt_thrash": thrash,
            "preempt_parked_depth": len(self._preempt_parked),
            "preempt_park_rate": park_rate,
            "quarantined_total": quarantined,
            "backend_demotions": demoted,
            "chunk_retries": retries,
            "backend": self.backend,
        }

    def windowed_miss_rate(self, window_s: Optional[float] = 1.0) -> float:
        """Deadline-miss fraction of completions over the trailing window
        (whole series when ``window_s`` is None)."""
        return self.timeseries.ratio(
            "engine.requests.deadline_missed",
            "engine.requests.completed",
            window_s,
        )

    # ------------------------------------------------------------- state
    def _alloc_buffers(self) -> None:
        """Allocate the chunk's static buffers and the host staging, once
        (``_grow_ring`` reallocates the rings; nothing else does), each
        shard's on its device."""
        cfg, S = self.cfg, self.S
        NL, L = cfg.layer_sizes[-1], cfg.num_layers
        for sh in self._shards:
            # the chunk's static buffers: written in place by every tick
            n, dev = sh.n, sh.device
            sh._states = runtime.init_states(cfg, n, device=dev)
            sh._meta = {
                k: torch.zeros((n,), dtype=torch.int32, device=dev)
                for k in ("done", "total", "admit", "fault")
            }
            sh._stats = torch.zeros(
                (2 * n * NL + n * L + n,), dtype=torch.float32, device=dev
            )
            sh._ring = self._alloc_ring(self._ring_steps, n, dev)
        self._alloc_staging()
        # stats land in one of pipeline_depth + 1 host buffers, each
        # reused only after its chunk retired; pinned on the card, behind
        # one event a device
        on_card = self.device.type == "cuda"
        self._host_stats = [
            torch.zeros((2 * S * NL + S * L + S,), dtype=torch.float32,
                        pin_memory=on_card)
            for _ in range(self.pipeline_depth + 1)
        ]
        self._stats_devices = list(dict.fromkeys(
            sh.device for sh in self._shards))
        self._host_ready = [
            [torch.cuda.Event() for _ in self._stats_devices] if on_card
            else None
            for _ in self._host_stats
        ]
        self._host_next = 0
        # each host buffer's copies: (shard, host view, stats view), the
        # four sections of every shard (spikes, membranes, events, fault;
        # each slot-major) at their global slot offsets; one copy for a
        # shard of every slot, whose layout is the global one
        self._stats_copies = []
        for host in self._host_stats:
            copies = []
            for sh in self._shards:
                if sh.n == S:
                    copies.append((sh, host, sh._stats))
                    continue
                g = b = 0  # the section's base: global, in the shard
                for w in (NL, NL, L, 1):
                    copies.append((sh, host[g + sh.lo * w:g + sh.hi * w],
                                   sh._stats[b:b + sh.n * w]))
                    g, b = g + S * w, b + sh.n * w
            self._stats_copies.append(copies)

    def _reset_host(self) -> None:
        """Reset the host-side serving state: slot bookkeeping, the
        queue, the parked lists, the stats pipeline.  Touches no device
        buffer, so ``restore`` can run it on an engine whose graph holds
        the buffers' addresses."""
        cfg, S = self.cfg, self.S
        NL, L = cfg.layer_sizes[-1], cfg.num_layers
        self._slot_req: List[Optional[int]] = [None] * S
        self._slot_parked = [False] * S  # admitted from the parked list
        self._slot_done = np.zeros(S, np.int64)  # steps dispatched
        self._slot_retired = np.zeros(S, np.int64)  # steps stats-retired
        self._slot_total = np.zeros(S, np.int64)
        self._slot_submit_t = np.zeros(S, np.float64)
        self._slot_admit_t = np.zeros(S, np.float64)
        self._slot_deadline: List[Optional[float]] = [None] * S
        self._slot_rel_deadline: List[Optional[float]] = [None] * S
        self._slot_priority = np.zeros(S, np.int64)
        self._slot_counts = np.zeros((S, NL), np.float64)
        self._slot_memsum = np.zeros((S, NL), np.float64)
        self._slot_events = np.zeros((S, L), np.float64)
        # stats pipeline: (host stats, ready event, take, rids)
        self._inflight: "collections.deque[Tuple]" = collections.deque()
        self._queue: List[tuple] = []  # heap: (key, rid, req, t_sub, dl)
        # admission plane: parked priority requests (FIFO, served
        # best-effort when the heap empties)
        self._parked: "collections.deque[tuple]" = collections.deque()
        # preemption buffer: host records of displaced mid-window slots
        # (state rows, ring row, accumulators), resumed by _fill_slot
        self._preempt_parked: List[Dict] = []
        self._pending_results: List[StreamResult] = []
        self.fault_events: List[Dict] = []
        self._tick_index = 0
        self._seq = 0
        self._next_rid = 0
        self._episode_open = False
        self._episode_t0 = 0.0
        self.metrics.reset(prefix="engine.episode.")

    def _begin_episode(self, now: float) -> None:
        # throughput and deadline counters are per episode: an episode
        # opens at the first submit on an idle engine and closes when the
        # last queued request drains.  One time-series sample opens it, so
        # the episode's first poll sample carries its submits' counts (a
        # series' first sample has no interval and counts in no window)
        self.timeseries.sample(now)
        self.metrics.reset(prefix="engine.episode.")
        self._episode_t0 = now
        self._episode_open = True

    # episode counters read straight from the registry
    @property
    def total_events(self) -> float:
        return self._m_events.value

    @property
    def total_steps(self) -> int:
        return int(self._m_steps.value)

    @property
    def completed(self) -> int:
        return int(self._m_completed.value)

    @property
    def deadline_misses(self) -> int:
        return int(self._m_misses.value)

    @property
    def wall_s(self) -> float:
        return self._m_wall.value

    def _alloc_ring(self, ring_steps: int, n: int,
                    device) -> Dict[str, torch.Tensor]:
        # Tc steps of zero padding keep every chunk slice inside the ring
        # at every done offset in [0, ring_steps]
        C, dev = self.C, device
        R = ring_steps + self.Tc
        return {
            "addrs": torch.zeros((n, R, C), dtype=self._addr_dtype, device=dev),
            "values": torch.zeros((n, R, C), dtype=torch.int8, device=dev),
            "counts": torch.zeros((n, R), dtype=torch.int32, device=dev),
        }

    def _alloc_staging(self) -> None:
        """Pinned staging, one byte buffer a slot, allocated once per ring
        size (the card only; the CPU uploads nothing).  It holds the
        ring's longest train for admission, or one slot's rows (states,
        ring row, metadata) for a resume or a restore (``_put_rows``),
        whichever is larger."""
        if self.device.type != "cuda":
            return
        rows = sum(-(-v.nbytes // 16) * 16 for v in self._slot_views(0))
        n = max(4 * self._ring_steps * self.cfg.layer_sizes[0], rows)
        for sh in self._shards:
            sh._pinned = [
                torch.empty((-(-n // 16) * 16,), dtype=torch.uint8,
                            pin_memory=True)
                for _ in range(sh.n)
            ]
            with _on(sh.device):
                sh._pinned_ready = [torch.cuda.Event() for _ in range(sh.n)]

    def _grow_ring(self, T: int) -> None:
        """Grow every shard's ring to hold a T-step train; other slots'
        staged trains survive.  The new rings are new graph inputs: the
        only allowed re-capture site, once a shard."""
        r_old = self._ring_steps + self.Tc
        self._ring_steps = int(T)
        for sh in self._shards:
            old = sh._ring
            sh._ring = self._alloc_ring(self._ring_steps, sh.n, sh.device)
            for k, buf in sh._ring.items():
                buf[:, :r_old] = old[k]
            # the admission graphs write the old ring: each (kind, T)
            # captures again over the new one, a new allowlisted signature
            sh._admit_graphs.clear()
            if self.graphed:
                sh._graph = None
                self._captures_expected += 1
        self._alloc_staging()

    # --------------------------------------------------------- admission
    def _resolve_steps(self, req: StreamRequest) -> int:
        T = self.cfg.num_steps if req.num_steps is None else int(req.num_steps)
        if T < 1:
            raise ValueError(f"num_steps must be >= 1, got {req.num_steps}")
        return T

    def submit(self, req: StreamRequest) -> int:
        """Enqueue one request; returns its request id.  Admission happens
        at the next ``poll()``.  Records a ``submit`` span, entry to
        return."""
        t_in = time.perf_counter()
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
            self._begin_episode(now)
        rid = self._next_rid
        self._next_rid += 1
        dl = now + req.deadline_s if req.deadline_s is not None else None
        self._m_submitted.inc()
        if self.admission is not None:
            verdict, reason = shed_mod.backpressure(
                self.admission,
                queue_depth=len(self._queue),
                parked_depth=len(self._parked),
                priority=req.priority,
            )
            if verdict == shed_mod.SHED:
                self._shed(rid, req, now, dl, reason)
                return self._submitted(rid, req, t_in)
            if verdict == shed_mod.PARK:
                self._park(rid, req, now, dl, reason)
                return self._submitted(rid, req, t_in)
        key = (
            -int(req.priority),
            0 if dl is not None else 1,  # deadline-less requests last
            dl if dl is not None else 0.0,
            self._seq,  # FIFO tiebreak
        )
        self._seq += 1
        heapq.heappush(self._queue, (key, rid, req, now, dl))
        self._m_qdepth.set(len(self._queue))
        return self._submitted(rid, req, t_in)

    def _submitted(self, rid: int, req: StreamRequest, t_in: float) -> int:
        self.trace.span(
            "submit", t_in, time.perf_counter(), track="queue",
            args={"rid": rid, "priority": req.priority},
        )
        return rid

    def _upload(
        self, s: int, arr: np.ndarray, out: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        """One host->device copy of a float32 array to slot ``s``'s
        device, into ``out`` when given (an admission graph's static
        input), else a new tensor.  On the card it goes through slot
        ``s``'s pinned staging buffer, so it does not wait for chunks in
        flight; the buffer is refilled only after its previous copy's
        event."""
        a = np.asarray(arr, dtype=np.float32)
        if self.device.type != "cuda":
            src = torch.from_numpy(a.copy())
            return src if out is None else out.copy_(src)
        sh, r = self._where[s]
        ready = sh._pinned_ready[r]
        ready.synchronize()  # the previous copy out of this buffer is done
        host = sh._pinned[r].view(torch.float32)[: a.size].view(a.shape)
        host.numpy()[...] = a
        with _on(sh.device):
            if out is None:
                out = torch.empty(a.shape, dtype=torch.float32,
                                  device=sh.device)
            out.copy_(host, non_blocking=True)
            ready.record()
        return out

    def _draw_uniforms(self, out: torch.Tensor) -> None:
        """An image's uniforms from the engine's generator into ``out``
        (an admission graph's static input): the eager engine's draw, in
        its shape and order, whichever device the shard is on (the
        generator is on the engine's own device)."""
        if out.device == self._slot_ids.device:
            coding.rate_uniforms(self._gen, out.shape, out=out)
        else:
            out.copy_(coding.rate_uniforms(self._gen, out.shape, self.device))

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
        t_stage = time.perf_counter()
        kind = "spikes" if req.spikes is not None else "image"
        data = req.spikes if req.spikes is not None else req.image
        if self.graphed:
            self._admit_graphed(s, kind, T, data)
        else:
            sh, r = self._where[s]
            x = self._upload(s, data)
            u = None
            if kind == "image":
                u = coding.rate_uniforms(self._gen, (T,) + tuple(x.shape),
                                         self.device).to(sh.device)
            with _on(sh.device):
                self._stage(sh._ring, sh._meta, sh._slot_ids[r:r + 1], x,
                            uniforms=u)
        self._slot_req[s] = rid
        self._slot_done[s] = 0
        self._slot_retired[s] = 0
        self._slot_total[s] = T
        self._slot_submit_t[s] = t_submit
        self._slot_admit_t[s] = time.perf_counter()
        # lifecycle spans: queued (submit -> stage start) on the queue
        # track, then the staging upload on the winning slot's track
        self.trace.span(
            "queue", t_submit, t_stage, track="queue",
            args={"rid": rid, "priority": req.priority},
        )
        self.trace.span(
            "stage", t_stage, self._slot_admit_t[s], track=f"slot{s}",
            args={"rid": rid, "steps": T},
        )
        self._m_qwait.record(self._slot_admit_t[s] - t_submit)
        self._slot_deadline[s] = abs_deadline
        self._slot_rel_deadline[s] = req.deadline_s
        self._slot_priority[s] = int(req.priority)
        self._slot_counts[s] = 0.0
        self._slot_memsum[s] = 0.0
        self._slot_events[s] = 0.0

    def _stage(
        self,
        ring,
        meta,
        slot: torch.Tensor,
        x: torch.Tensor,
        *,
        uniforms: Optional[torch.Tensor] = None,
    ) -> None:
        """Pack a request into the slot at device index ``slot`` ((1,)
        int64) of ``ring`` and reset its metadata in ``meta``, in place,
        by index ops, without a host read: the counterpart of the
        reference's jitted ``stage`` with its donated ring and metadata.
        ``x`` is the (T, K) train, or with ``uniforms`` (T, K) the (K,)
        image they rate-code (``coding.rate_code``).  Writes ring rows
        ``[:T]`` only; the slot's later rows keep what they held.  An
        admission graph captures this call over static inputs."""
        train = x if uniforms is None else coding.rate_code(x, uniforms)
        T = train.shape[0]
        table = runtime.encode_step_table(
            train, self.C, addr_dtype=self._addr_dtype
        )
        ring["addrs"][:, :T].index_copy_(0, slot, table.addrs[None])
        ring["values"][:, :T].index_copy_(0, slot, table.values[None])
        ring["counts"][:, :T].index_copy_(0, slot, table.counts[None])
        meta["done"].index_fill_(0, slot, 0)
        meta["total"].index_fill_(0, slot, T)
        meta["admit"].index_fill_(0, slot, 1)
        if not self.fault_checks:
            meta["fault"].index_fill_(0, slot, 0)
            return
        # a step with more nonzero inputs than C would be truncated
        # silently by the packed table: flag it for quarantine
        over = torch.any(torch.sum(train != 0, dim=-1) > self.C)
        code = over.to(torch.int32) * FAULT_CAPACITY_OVERFLOW
        meta["fault"].index_copy_(0, slot, code.reshape(1))

    # the reference's donate_argnums of its jitted admission: the ring and
    # the metadata are updated in place (analysis.contracts reads this)
    _stage.donate_argnums = (0, 1)

    def _admit_graphed(self, s: int, kind: str, T: int, data) -> None:
        """Stage a request into slot ``s`` through its shard's admission
        graph of ``(kind, T)``, capturing it first where this ring size
        has none: the upload into the graph's static input, an image's
        uniforms drawn into their static buffer outside the graph (the
        eager engine's draw, in its shape and order), the slot's local
        index set by a device-to-device copy, then one replay.  A failed
        capture or replay raises."""
        sh, r = self._where[s]
        entry = sh._admit_graphs.get((kind, T))
        if entry is None:
            entry = sh._admit_graphs[(kind, T)] = self._capture_admit(
                sh, kind, T)
        ins = entry["inputs"]
        self._upload(s, data, out=ins["x"])
        with _on(sh.device):
            if kind == "image":
                self._draw_uniforms(ins["uniforms"])
            ins["slot"].copy_(sh._slot_ids[r:r + 1])
            entry["graph"].replay()
        self.admit_replays += 1

    def _capture_admit(self, sh: _SlotShard, kind: str, T: int) -> Dict:
        """Shard ``sh``'s admission graph of requests of ``kind`` over
        ``T`` steps at this ring size, with its static inputs (the local
        slot index, the (T, K) train or the (K,) image and its (T, K)
        uniforms) and the ring and metadata it writes.  The first capture
        of ``(shard, kind, T)`` at a ring size is allowlisted; any other
        counts as a re-capture."""
        t0 = time.perf_counter()
        dev, K = sh.device, self.cfg.layer_sizes[0]
        ins = {"slot": sh._slot_ids[:1].clone(), "ring": sh._ring,
               "meta": sh._meta}
        if kind == "image":
            ins["x"] = torch.zeros((K,), dtype=torch.float32, device=dev)
            ins["uniforms"] = torch.zeros((T, K), dtype=torch.float32,
                                          device=dev)
        else:
            ins["x"] = torch.zeros((T, K), dtype=torch.float32, device=dev)
        with _on(dev):
            graph = self._capture_stage(ins)
        self.admit_captures += 1
        contracts.note_capture()
        self._admit_signatures.add((sh.index, kind, T, self._ring_steps))
        self._note_captures()
        self.trace.span("admit_capture", t0, time.perf_counter(),
                        track="engine",
                        args={"kind": kind, "steps": T, "shard": sh.index})
        return {"graph": graph, "inputs": ins}

    def _capture_stage(self, ins: Dict):
        """Capture ``_stage`` over the static inputs ``ins`` into the ring
        and metadata ``ins["ring"]``/``ins["meta"]`` (a shard's live
        buffers) as a CUDA graph, on the current device.  A warm-up call
        runs first on a side stream over copies of the ring and metadata,
        so capturing writes no live slot.  The graph takes a memory pool
        of its own: the tick graphs and the admission graphs replay in no
        fixed order."""
        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._stage(
                {k: v.clone() for k, v in ins["ring"].items()},
                {k: v.clone() for k, v in ins["meta"].items()},
                ins["slot"], ins["x"], uniforms=ins.get("uniforms"),
            )
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # captured on the side stream, of the current device: the graph
        # context's own default stream belongs to the device that was
        # current when the process made its first graph
        with contracts.no_collection(), torch.cuda.graph(graph, stream=side):
            self._stage(ins["ring"], ins["meta"], ins["slot"], ins["x"],
                        uniforms=ins.get("uniforms"))
        return graph

    # --------------------------------------------------- admission plane
    def _void_result(
        self,
        rid: int,
        req: StreamRequest,
        t_submit: float,
        *,
        disposition: str,
        fault: Optional[str],
    ) -> StreamResult:
        """A result that carries a disposition instead of an inference: no
        prediction, no stats, no deadline verdict (the request was never
        served, so it neither met nor missed anything)."""
        cfg = self.cfg
        now = time.perf_counter()
        return StreamResult(
            request_id=rid,
            prediction=-1,
            spike_counts=np.zeros(cfg.layer_sizes[-1]),
            steps=self._resolve_steps(req),
            latency_s=now - t_submit,
            queue_wait_s=now - t_submit,
            events_per_layer=np.zeros(cfg.num_layers),
            spike_rate=0.0,
            energy_pj=0.0,
            deadline_s=req.deadline_s,
            deadline_missed=False,
            disposition=disposition,
            fault=fault,
        )

    def _shed(
        self,
        rid: int,
        req: StreamRequest,
        t_submit: float,
        abs_deadline: Optional[float],
        reason: str,
    ) -> None:
        self._m_shed.inc()
        self.trace.instant(
            "shed", time.perf_counter(), track="queue",
            args={"rid": rid, "reason": reason},
        )
        self._pending_results.append(self._void_result(
            rid, req, t_submit, disposition="shed", fault=reason
        ))

    def _park(
        self,
        rid: int,
        req: StreamRequest,
        t_submit: float,
        abs_deadline: Optional[float],
        reason: str,
    ) -> None:
        self._m_parked_total.inc()
        self._parked.append((rid, req, t_submit, abs_deadline))
        self._m_parked_depth.set(len(self._parked))
        self.trace.instant(
            "park", time.perf_counter(), track="queue",
            args={"rid": rid, "reason": reason},
        )

    def measured_ticks_per_s(self, window_s: Optional[float] = None) -> float:
        """Tick throughput off the time-series sampler (trailing
        ``window_s``, falling back to the whole series when the window
        saw no flow): the evidence the feasibility shedder turns into a
        completion-time lower bound.  0.0 on a cold engine.  Wall-clock
        state: it follows how fast the tick runs on this machine."""
        key = "engine.tick.dispatch_s.count"
        r = self.timeseries.rate(key, window_s)
        if r <= 0.0:
            r = self.timeseries.rate(key, None)
        return r

    def _admission_verdict(
        self, req: StreamRequest, abs_deadline: Optional[float]
    ) -> Tuple[str, Optional[str]]:
        """Feasibility check when a queued request wins a free slot."""
        if self.admission is None or not self.admission.shed_unmeetable:
            return shed_mod.ADMIT, None
        return shed_mod.feasibility(
            self.admission,
            steps=self._resolve_steps(req),
            chunk_steps=self.Tc,
            deadline_abs=abs_deadline,
            now=time.perf_counter(),
            ticks_per_s=self.measured_ticks_per_s(
                self.admission.rate_window_s
            ),
            priority=req.priority,
        )

    # ------------------------------------------------------------- chunk
    def _chunk(self, prepared, states, ring, meta, stats) -> None:
        """One tick on the device, in place: reads ``ring`` and the
        incoming ``states``/``meta``, then writes the new states, the new
        metadata and the per-slot stats into ``states``, ``meta`` and
        ``stats`` with ``copy_``, after every read of them.  Makes no
        host read, so a CUDA graph can capture it."""
        cfg, Tc, C = self.cfg, self.Tc, self.C
        done, total, admit = meta["done"], meta["total"], meta["admit"]
        # the slots' local ids, step and lane ids on the buffers' device
        slot_ids, step_ids, lane_ids = self._consts[done.device]
        take = torch.clamp(total - done, 0, Tc)
        act = (take > 0).to(torch.float32)
        # slots admitted since the previous chunk start from zero state
        fresh = admit[:, None] > 0
        incoming = [
            neuron.NeuronState(
                u=torch.where(fresh, 0.0, st.u),
                refrac=torch.where(fresh, 0, st.refrac),
            )
            for st in states
        ]
        # each slot's next Tc steps out of its ring, slot-major (S, Tc, C)
        rows = slot_ids[:done.shape[0], None]
        steps = done[:, None].long() + step_ids[None, :]
        a_c = ring["addrs"][rows, steps]
        v_c = ring["values"][rows, steps]
        c_c = ring["counts"][rows, steps]
        # silence steps past the request's window: there the ring holds a
        # previous occupant's stale events
        in_window = step_ids[None, :] < take[:, None]
        values = torch.where(in_window[:, :, None], v_c, 0)
        counts = torch.where(in_window, c_c, 0)
        new_states, out_mem, out_spikes, events = runtime.run_chunk_events(
            prepared, incoming, a_c, values, counts, cfg,
            active=act, capacities=self.capacities, prepared=True,
            backend=self.backend, layout="slot_major",
        )
        # per-slot fault bitmask, masked to the request's own window;
        # faulted slots are zeroed here so they never contaminate a later
        # occupant (a bit-exact no-op for clean slots)
        fault = meta["fault"]
        if self.fault_checks:
            bad_state = torch.zeros_like(in_window[:, 0])
            for st in new_states:
                bad_state = bad_state | ~torch.isfinite(st.u).all(dim=-1)
            bad_count = ((counts < 0) | (counts > C)).any(dim=-1)
            ev_valid = in_window[:, :, None] & (
                lane_ids[None, None, :]
                < torch.clamp(counts, 0, C)[:, :, None]
            )
            a32 = a_c.to(torch.int32)
            bad_addr = (
                (ev_valid & ((a32 < 0) | (a32 >= cfg.layer_sizes[0])))
                .flatten(1)
                .any(dim=1)
            )
            fault = (
                fault
                | bad_state.to(torch.int32) * FAULT_NONFINITE_STATE
                | (bad_count | bad_addr).to(torch.int32) * FAULT_RING_CORRUPT
            )
            poisoned = (fault > 0)[:, None]
            new_states = [
                neuron.NeuronState(
                    u=torch.where(poisoned, 0.0, new.u),
                    refrac=torch.where(poisoned, 0, new.refrac),
                )
                for new in new_states
            ]
        # per-slot stats over the request's own steps only
        m = (step_ids[:, None] < take[None, :]).to(torch.float32)
        torch.cat([
            torch.sum(out_spikes * m[:, :, None], dim=0).flatten(),
            torch.sum(out_mem * m[:, :, None], dim=0).flatten(),
            torch.sum(events * m[:, None, :], dim=0).T.flatten(),
            fault.to(torch.float32),
        ], out=stats)
        # the writes, after every read of the buffers they overwrite
        for st, new in zip(states, new_states):
            st.u.copy_(new.u)
            st.refrac.copy_(new.refrac)
        meta["done"].add_(take)
        meta["admit"].zero_()
        # staged fault bits report exactly once, then clear
        meta["fault"].zero_()

    # the reference's donate_argnums of its jitted chunk: the states and
    # the metadata are updated in place (analysis.contracts reads this)
    _chunk.donate_argnums = (1, 3)

    def _capture(self) -> None:
        """Capture ``_chunk`` into a CUDA graph for every shard that has
        none (each over its own static buffers, on its own device).
        Raises if a capture fails; nothing runs eagerly instead."""
        for sh in self._shards:
            if sh._graph is None:
                with _on(sh.device):
                    self._capture_shard(sh)

    def _capture_shard(self, sh: _SlotShard) -> None:
        """Capture ``_chunk`` over shard ``sh``'s static buffers.

        A warm-up call on copies runs first on a side stream, as
        ``torch.cuda.graph`` requires: it builds the kernel, raises its
        shared-memory limit and fills the plan cache, and leaves the
        engine's buffers untouched (capture records work, runs none)."""
        from repro_torch.kernels import snn_chunk as chunk_mod

        cur = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self._chunk_on_copies(sh._prepared, sh._states, sh._ring,
                                  sh._meta)
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = chunk_mod.snn_chunk.captured
        # on this device's side stream (see ``_capture_stage``)
        with contracts.no_collection(), torch.cuda.graph(graph, stream=side):
            self._chunk(sh._prepared, sh._states, sh._ring, sh._meta,
                        sh._stats)
        self.graph_launches_per_replay = chunk_mod.snn_chunk.captured - before
        sh._graph = graph
        self.graph_captures += 1
        contracts.note_capture()
        self._note_captures()

    @property
    def _admit_captures_expected(self) -> int:
        """The admission graphs' allowlist: the (kind, T, ring size)
        signatures captured so far, each allowed once."""
        return len(self._admit_signatures)

    def _note_captures(self) -> None:
        """Fold captures beyond the allowlisted sites (cold start, ring
        growth, the first capture of each admission signature at a ring
        size) into the ``engine.tick.recompiles`` counter."""
        extra = max(0, self.graph_captures - self._captures_expected) + max(
            0, self.admit_captures - self._admit_captures_expected)
        if extra > self._captures_accounted:
            self._m_recompiles.inc(extra - self._captures_accounted)
            self._captures_accounted = extra

    def steady_state_recompiles(self) -> int:
        """Chunk and admission re-captures beyond the known capture sites
        (lifetime); nonzero means some dispatch path is not static."""
        return int(self._m_recompiles.value)

    def _run_chunk(self) -> None:
        """One chunk over every shard's static buffers: each shard's graph
        replayed, or its chunk run eagerly (the CPU, the plain backends, a
        demoted engine)."""
        for sh in self._shards:
            with _on(sh.device):
                if self.graphed:
                    sh._graph.replay()
                    self.graph_replays += 1
                else:
                    self._chunk(sh._prepared, sh._states, sh._ring, sh._meta,
                                sh._stats)

    def _demote(self):
        """The supervisor's fallback after persistent ``fused`` failures:
        the plain ``torch`` chunk, run eagerly over the same buffers; every
        shard's graphs are dropped.  Returns the attempt to retry."""
        self.backend = "torch"
        self.graphed = False
        for sh in self._shards:
            sh._graph = None
            sh._admit_graphs.clear()
        return self._attempt

    def _attempt(self) -> None:
        """One supervised dispatch attempt: an injected fault raises
        before the chunk writes any buffer, so the attempt may run
        again."""
        if self.injector is not None:
            self.injector.maybe_raise(self.backend)
        self._run_chunk()

    def _dispatch_chunk(self, take: np.ndarray) -> None:
        # the graphs' captures stay outside the supervised attempt (the
        # kernel was built at construction): a failed capture raises,
        # never retries or demotes
        if self.graphed and any(sh._graph is None for sh in self._shards):
            self._capture()
        self._supervisor.call(
            self._attempt,
            backend=self.backend,
            demote=self._demote if self.backend == "fused" else None,
        )
        # start the stats' trip to the host now, so reading them later
        # waits for this chunk only, not for chunks dispatched after it:
        # each shard's sections into their global slot offsets
        i = self._host_next
        self._host_next = (i + 1) % len(self._host_stats)
        host, ready = self._host_stats[i], self._host_ready[i]
        for sh, dst, src in self._stats_copies[i]:
            with _on(sh.device):
                dst.copy_(src, non_blocking=ready is not None)
        if ready is not None:
            for dev, ev in zip(self._stats_devices, ready):
                with _on(dev):
                    ev.record()
        self._inflight.append((host, ready, take.copy(), list(self._slot_req)))
        self.dispatched_ticks += 1

    # -------------------------------------------------------------- tick
    def _tick(self) -> List[int]:
        """Dispatch the next chunk (if any slot has steps left) and retire
        pipelined stats; returns the slots whose requests finished.

        A steady mid-window tick uploads nothing, allocates nothing on the
        card or in pinned memory, and reads the host once (``_fetch``)."""
        S, Tc = self.S, self.Tc
        tick = self._tick_index
        self._tick_index += 1
        if self.injector is not None:
            applied = self.injector.begin_tick(self, tick)
            if applied:
                self._m_injected.inc(len(applied))
            if self.injector.stalled(tick):
                # an injected stall: the tick makes no progress at all,
                # the wedge drain(timeout_s=...) must survive
                return []
        t0 = time.perf_counter()
        take = np.zeros(S, np.int32)
        for s in range(S):
            if self._slot_req[s] is not None:
                take[s] = min(Tc, int(self._slot_total[s] - self._slot_done[s]))
        dispatched = bool(take.sum() > 0)
        t1 = time.perf_counter()
        if dispatched:
            self._dispatch_chunk(take)
            self._slot_done += take
        t2 = time.perf_counter()
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
        t3 = time.perf_counter()
        # tick-phase instruments: exact sums for tick_breakdown, tails,
        # and spans that show stalls and pipeline bubbles on a timeline
        self._m_prep.record(t1 - t0)
        self._m_dispatch.record(t2 - t1)
        self._m_fetch.record(t3 - t2)
        self._m_active.set(sum(r is not None for r in self._slot_req))
        self.trace.span("host_prep", t0, t1, track="tick")
        if dispatched:
            # one span a tick, whatever the slots: it names the requests
            # the chunk advanced
            rids = [self._slot_req[s] for s in np.flatnonzero(take)]
            self.trace.span(
                "dispatch", t1, t2, track="tick",
                args={"steps": int(take.sum()), "rids": rids},
            )
        self.trace.span("stats_fetch", t2, t3, track="tick")
        return finished

    def _fetch(self, host: torch.Tensor, ready) -> np.ndarray:
        """The tick's single device-to-host read: wait for the chunk's
        stats copies (their event on each device, on the card) and view
        them."""
        for ev in ready or ():
            ev.synchronize()
        return host.numpy()

    def _retire(self) -> List[int]:
        """Read the oldest in-flight chunk's stats and fold them into the
        per-slot accumulators."""
        host, ready, take, rids = self._inflight.popleft()
        flat = self._fetch(host, ready)
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
            self._m_events.inc(float(events[s].sum()))
            self._m_steps.inc(int(take[s]))
            if self._slot_retired[s] >= self._slot_total[s]:
                finished.append(s)
        return finished

    def _quarantine(self, s: int, code: int) -> None:
        """Fail slot ``s``'s request into a quarantined result and free the
        slot; its folded work leaves the throughput numerator."""
        rid = self._slot_req[s]
        names = fault_code_names(code)
        now = time.perf_counter()
        self._m_q_events.inc(float(self._slot_events[s].sum()))
        self._m_q_steps.inc(float(self._slot_retired[s]))
        self._m_quarantined.inc()
        self.fault_events.append({
            "tick": self._tick_index, "slot": s, "rid": rid, "code": code,
            "fault": names,
        })
        self.trace.instant(
            "quarantine", now, track=f"slot{s}",
            args={"rid": rid, "fault": names},
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
            parked=self._slot_parked[s],
        ))
        self._slot_req[s] = None
        self._slot_parked[s] = False

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
        self._m_completed.inc()
        self._m_finished.inc()
        if missed:
            self._m_misses.inc()
            self._m_missed_total.inc()
        latency_s = finish_t - self._slot_submit_t[s]
        self._m_latency.record(latency_s)
        self._m_energy.record(oc.energy_pj())
        self.trace.instant(
            "complete", finish_t, track=f"slot{s}",
            args={
                "rid": self._slot_req[s],
                "latency_ms": latency_s * 1e3,
                "energy_pj": oc.energy_pj(),
                "deadline_missed": bool(missed),
            },
        )
        res = StreamResult(
            request_id=self._slot_req[s],
            prediction=pred,
            spike_counts=counts.copy(),
            steps=T,
            latency_s=latency_s,
            queue_wait_s=self._slot_admit_t[s] - self._slot_submit_t[s],
            events_per_layer=ev,
            spike_rate=float(ev[0] / (T * cfg.layer_sizes[0])),
            energy_pj=oc.energy_pj(),
            deadline_s=self._slot_rel_deadline[s],
            deadline_missed=missed,
            parked=self._slot_parked[s],
        )
        self._slot_req[s] = None
        self._slot_parked[s] = False
        return res

    # ------------------------------------------------------ device rows
    def _host_copy(self, t: torch.Tensor) -> np.ndarray:
        """A host copy of ``t`` (never a view of an engine buffer)."""
        return t.detach().to("cpu", copy=True).numpy()

    def _slot_views(
        self, s: int, r: Optional[int] = None
    ) -> List[torch.Tensor]:
        """Slot ``s``'s rows of its shard's chunk buffers, in a fixed
        order: each layer's membrane and refractory row, the first ``r``
        steps (all by default) of its ring rows, its metadata."""
        sh, j = self._where[s]
        views = []
        for st in sh._states:
            views += [st.u[j], st.refrac[j]]
        views += [buf[j, :r] for buf in sh._ring.values()]
        views += [buf[j:j + 1] for buf in sh._meta.values()]
        return views

    def _put_rows(self, s: int, pairs) -> None:
        """Write host arrays into views of the engine's buffers in place,
        ``pairs`` of (view, array) for slot ``s``.  On the card the arrays
        are packed into the slot's pinned staging buffer and copied from
        it on its device's current stream, ahead of the next replay that
        reads them; the buffer's event keeps it from being refilled before
        the copies are done."""
        if self.device.type != "cuda":
            for dst, arr in pairs:
                src = torch.from_numpy(np.ascontiguousarray(arr))
                dst.copy_(src.reshape(dst.shape))
            return
        sh, j = self._where[s]
        ready = sh._pinned_ready[j]
        ready.synchronize()  # the previous copy out of this buffer is done
        raw, off = sh._pinned[j], 0
        with _on(sh.device):
            for dst, arr in pairs:
                n = dst.numel() * dst.element_size()
                if off + n > raw.numel():
                    raise RuntimeError(
                        f"slot {s}'s rows do not fit its pinned staging "
                        f"({raw.numel()} bytes)"
                    )
                host = raw[off:off + n].view(dst.dtype).view(dst.shape)
                host.numpy()[...] = np.asarray(arr).reshape(dst.shape)
                dst.copy_(host, non_blocking=True)
                off += -(-n // 16) * 16
            ready.record()

    # -------------------------------------------------------- preemption
    def _drain_inflight(self) -> None:
        """Retire every pipelined chunk's stats, finalizing the requests
        they complete into the pending results: the consistency point
        ``snapshot`` and parking need.  Afterwards ``_slot_retired ==
        _slot_done`` for every resident slot, so host accumulators match
        the device state."""
        while self._inflight:
            for s in self._retire():
                self._pending_results.append(self._finalize(s))

    def _slot_key(self, s: int):
        """Urgency key of slot ``s``'s resident request, comparable with
        the admission heap's key prefix (priority desc, deadline-less
        last, EDF)."""
        dl = self._slot_deadline[s]
        return (
            -int(self._slot_priority[s]),
            0 if dl is not None else 1,
            dl if dl is not None else 0.0,
        )

    def _best_preempt_key(self) -> Optional[Tuple]:
        """(key, index) of the most urgent preempt-parked window, or None
        when the buffer is empty."""
        best = None
        for i, rec in enumerate(self._preempt_parked):
            dl = rec["abs_deadline"]
            k = (
                -int(rec["priority"]),
                0 if dl is not None else 1,
                dl if dl is not None else 0.0,
            )
            if best is None or k < best[0]:
                best = (k, i)
        return best

    def _victim(self, head_key) -> Optional[int]:
        """The loosest resident slot *strictly* looser than ``head_key``,
        or None: an equal-urgency arrival never displaces a running window
        (ties would swap-thrash)."""
        worst, worst_key = None, None
        for s in range(self.S):
            if self._slot_req[s] is None:
                continue
            k = self._slot_key(s)
            if worst_key is None or k > worst_key:
                worst, worst_key = s, k
        if worst is None or not (head_key < worst_key):
            return None
        return worst

    def _maybe_preempt(self) -> None:
        """Park the loosest resident window when the queue head is
        strictly more urgent and no slot is free (``preempt=True`` only).
        At most one park a poll round; the freed slot takes the urgent
        request in the same round."""
        if not self.preempt or not self._queue:
            return
        if any(r is None for r in self._slot_req):
            return  # a free slot serves the arrival without displacement
        head_key = self._queue[0][0][:3]
        if self._victim(head_key) is None:
            return
        # retire pipelined stats before parking: retirement may complete a
        # slot outright (cheaper than a park/resume round trip), and
        # parking needs retired == done; a parked slot with a chunk still
        # in flight would drop that chunk's stats at _retire's slot-reuse
        # guard
        self._drain_inflight()
        if any(r is None for r in self._slot_req):
            return
        v = self._victim(head_key)
        if v is not None:
            self._park_slot(v)

    def _park_slot(self, s: int) -> None:
        """Preempt slot ``s``: read its membrane/refractory rows, ring row
        and host accumulators into the parking buffer and free the slot.
        The caller has drained the stats pipeline.  Inverse of
        ``_resume_slot``; the round trip is bit-exact."""
        t0 = time.perf_counter()
        rid = self._slot_req[s]
        sh, j = self._where[s]
        rec = {
            "rid": rid,
            "priority": int(self._slot_priority[s]),
            "done": int(self._slot_retired[s]),
            "total": int(self._slot_total[s]),
            "parked": bool(self._slot_parked[s]),
            "ring_steps": self._ring_steps,
            "rel_deadline": self._slot_rel_deadline[s],
            "abs_deadline": self._slot_deadline[s],
            "t_submit": float(self._slot_submit_t[s]),
            "t_admit": float(self._slot_admit_t[s]),
            "u": [self._host_copy(st.u[j]) for st in sh._states],
            "refrac": [self._host_copy(st.refrac[j]) for st in sh._states],
            "ring_addrs": self._host_copy(sh._ring["addrs"][j]),
            "ring_values": self._host_copy(sh._ring["values"][j]),
            "ring_counts": self._host_copy(sh._ring["counts"][j]),
            "counts": self._slot_counts[s].copy(),
            "memsum": self._slot_memsum[s].copy(),
            "events": self._slot_events[s].copy(),
        }
        self._preempt_parked.append(rec)
        # free the slot: total = 0 makes the next chunk take nothing from
        # it; the stale device rows are dead weight until overwritten
        for buf in sh._meta.values():
            buf[j] = 0
        self._slot_req[s] = None
        self._slot_parked[s] = False
        t1 = time.perf_counter()
        self._m_preempt_parked.inc()
        self._m_preempt_events.inc(float(rec["events"].sum()))
        self._m_park_time.record(t1 - t0)
        self._m_preempt_depth.set(len(self._preempt_parked))
        self.trace.span(
            "park", t0, t1, track=f"slot{s}",
            args={"rid": rid, "done": rec["done"], "total": rec["total"]},
        )

    def _resume_slot(self, s: int, rec: Dict) -> None:
        """Admit a preempt-parked window into free slot ``s``, writing its
        state and ring rows back in place.  The admit flag stays 0 (the
        chunk must not zero the restored membranes), so the window
        continues from exactly the step it was parked at."""
        t0 = time.perf_counter()
        if rec["ring_steps"] > self._ring_steps:
            # only across a restore onto a smaller-ring engine: grow back
            # so the stored row fits (the allowlisted re-capture site)
            self._grow_ring(rec["ring_steps"])
        meta = {"done": rec["done"], "total": rec["total"], "admit": 0,
                "fault": 0}
        rows = [a for u, rf in zip(rec["u"], rec["refrac"]) for a in (u, rf)]
        rows += [rec[f"ring_{k}"] for k in ("addrs", "values", "counts")]
        rows += [np.array([meta[k]], np.int32)
                 for k in ("done", "total", "admit", "fault")]
        views = self._slot_views(s, rec["ring_addrs"].shape[0])
        self._put_rows(s, list(zip(views, rows)))
        self._slot_req[s] = rec["rid"]
        self._slot_parked[s] = rec["parked"]
        self._slot_priority[s] = rec["priority"]
        self._slot_done[s] = rec["done"]
        self._slot_retired[s] = rec["done"]
        self._slot_total[s] = rec["total"]
        self._slot_submit_t[s] = rec["t_submit"]
        self._slot_admit_t[s] = rec["t_admit"]
        self._slot_deadline[s] = rec["abs_deadline"]
        self._slot_rel_deadline[s] = rec["rel_deadline"]
        self._slot_counts[s] = rec["counts"]
        self._slot_memsum[s] = rec["memsum"]
        self._slot_events[s] = rec["events"]
        t1 = time.perf_counter()
        self._m_preempt_resumed.inc()
        self._m_restore_time.record(t1 - t0)
        self._m_preempt_depth.set(len(self._preempt_parked))
        self.trace.span(
            "resume", t0, t1, track=f"slot{s}",
            args={"rid": rec["rid"], "done": rec["done"],
                  "total": rec["total"]},
        )

    # --------------------------------------------------- crash-safe state
    def snapshot(self, path: str) -> str:
        """Serialize the engine's complete serving state into the
        directory ``path``: per-slot membrane/refractory states, the
        packed rings, the scheduling metadata, host bookkeeping, the
        admission queue, parked requests, the preemption buffer,
        undelivered results, the generator's state and the fault log.
        Atomic (tmp dir + rename + per-array crc32 through the checkpoint
        plane): a crash mid-snapshot leaves the previous one intact.

        The arrays and manifest keys are the reference engine's, so a
        snapshot the reference wrote restores here; the random state is
        the one difference: the port stores its generator's state as
        ``rng_state`` where the reference stores ``rng_key``.
        Wall-clock state is stored as remaining deadline budgets and
        ages, which :meth:`restore` re-anchors."""
        t0 = time.perf_counter()
        # consistency point: retire all pipelined stats (finalizing any
        # windows they complete) so host accumulators match device state
        self._drain_inflight()
        now = time.perf_counter()
        arrays: Dict[str, np.ndarray] = {}

        def gather(get):  # every shard's rows, in global slot order
            return np.concatenate(
                [self._host_copy(get(sh)) for sh in self._shards])

        for i in range(self.cfg.num_layers):
            arrays[f"state{i}_u"] = gather(lambda sh: sh._states[i].u)
            arrays[f"state{i}_refrac"] = gather(
                lambda sh: sh._states[i].refrac)
        for k in ("addrs", "values", "counts"):
            arrays[f"ring_{k}"] = gather(lambda sh: sh._ring[k])
        for k in ("done", "total", "admit", "fault"):
            arrays[f"meta_{k}"] = gather(lambda sh: sh._meta[k])
        arrays["rng_state"] = self._gen.get_state().numpy().copy()
        for name in ("done", "retired", "total", "priority"):
            arrays[f"slot_{name}"] = getattr(self, f"_slot_{name}").copy()
        arrays["slot_counts"] = self._slot_counts.copy()
        arrays["slot_memsum"] = self._slot_memsum.copy()
        arrays["slot_events"] = self._slot_events.copy()
        slots = []
        for s in range(self.S):
            dl = self._slot_deadline[s]
            slots.append({
                "rid": self._slot_req[s],
                "parked": bool(self._slot_parked[s]),
                "rel_deadline": self._slot_rel_deadline[s],
                "deadline_remaining_s": None if dl is None else dl - now,
                "submit_age_s": now - float(self._slot_submit_t[s]),
                "admit_age_s": now - float(self._slot_admit_t[s]),
            })

        def pack_req(prefix, rid, req, t_sub, dl, extra=None):
            if req.spikes is not None:
                arrays[f"{prefix}_spikes"] = np.asarray(req.spikes)
            else:
                arrays[f"{prefix}_image"] = np.asarray(req.image)
            doc = {
                "rid": rid,
                "priority": int(req.priority),
                "num_steps": req.num_steps,
                "deadline_s": req.deadline_s,
                "submit_age_s": now - t_sub,
                "deadline_remaining_s": None if dl is None else dl - now,
            }
            doc.update(extra or {})
            return doc

        queue_docs = [
            pack_req(f"q{i}", rid, req, t_sub, dl, {"seq": key[3]})
            for i, (key, rid, req, t_sub, dl) in enumerate(sorted(
                self._queue, key=lambda e: e[0]))
        ]
        parked_docs = [
            pack_req(f"p{i}", rid, req, t_sub, dl)
            for i, (rid, req, t_sub, dl) in enumerate(self._parked)
        ]
        pp_docs = []
        for i, rec in enumerate(self._preempt_parked):
            for layer in range(len(rec["u"])):
                arrays[f"pp{i}_u{layer}"] = rec["u"][layer]
                arrays[f"pp{i}_refrac{layer}"] = rec["refrac"][layer]
            for k in ("ring_addrs", "ring_values", "ring_counts",
                      "counts", "memsum", "events"):
                arrays[f"pp{i}_{k}"] = rec[k]
            dl = rec["abs_deadline"]
            pp_docs.append({
                "rid": rec["rid"],
                "priority": rec["priority"],
                "done": rec["done"],
                "total": rec["total"],
                "parked": rec["parked"],
                "ring_steps": rec["ring_steps"],
                "rel_deadline": rec["rel_deadline"],
                "deadline_remaining_s": None if dl is None else dl - now,
                "submit_age_s": now - rec["t_submit"],
                "admit_age_s": now - rec["t_admit"],
            })
        manifest = {
            "kind": "snn_engine_snapshot",
            "geometry": {
                "num_slots": self.S,
                "chunk_steps": self.Tc,
                "event_capacity": self.C,
                "ring_steps": self._ring_steps,
                "layer_sizes": list(self.cfg.layer_sizes),
            },
            "backend": self.backend,
            "tick_index": self._tick_index,
            "seq": self._seq,
            "next_rid": self._next_rid,
            "snap_index": self._snap_index,
            "episode_open": self._episode_open,
            "episode_age_s": (
                now - self._episode_t0 if self._episode_open else 0.0
            ),
            "slots": slots,
            "queue": queue_docs,
            "parked": parked_docs,
            "preempt_parked": pp_docs,
            "pending_results": [
                _doc_result(r) for r in self._pending_results
            ],
            "fault_events": list(self.fault_events),
        }
        path = os.path.normpath(path)
        out = publish_array_dir(
            os.path.dirname(path) or ".", os.path.basename(path), arrays,
            manifest,
        )
        t1 = time.perf_counter()
        self._m_snap_time.record(t1 - t0)
        self.trace.span("snapshot", t0, t1, track="engine",
                        args={"path": out})
        return out

    def restore(self, path: str) -> None:
        """Load a snapshot written by :meth:`snapshot` (or by the
        reference engine's) into this engine, built with the same params
        and config.  Raises :class:`CheckpointCorruptError` when the
        snapshot fails its checksums, ValueError on a geometry mismatch.

        The arrays are copied **into the existing buffers**: the CUDA
        graph holds their addresses, so an engine that has captured keeps
        its graph and re-captures nothing.  A snapshot whose ring is
        longer than this engine's grows the ring first (``_grow_ring``,
        the one allowed re-capture site); a shorter one fills the head of
        the ring.  The tick-phase histograms and the re-capture count are
        the engine's lifetime and survive.

        A reference snapshot carries a threefry ``rng_key`` where the
        port stores ``rng_state``: the generator is then seeded from the
        key's words, so the draws of images admitted after such a restore
        differ from the reference's by design (torch cannot reproduce the
        threefry stream); spike-train requests are unaffected.  The
        manifest's ``backend`` is recorded in the restore span, the
        reference's ``"jnp"`` read as the port's ``"torch"``."""
        t_start = time.perf_counter()
        path = os.path.normpath(path)
        arrays, manifest = load_array_dir(path)
        if manifest.get("kind") != "snn_engine_snapshot":
            raise ValueError(f"{path} is not an engine snapshot")
        g = manifest["geometry"]
        want = {
            "num_slots": self.S,
            "chunk_steps": self.Tc,
            "event_capacity": self.C,
            "layer_sizes": list(self.cfg.layer_sizes),
        }
        got = {k: g.get(k) for k in want}
        if got != want:
            raise ValueError(
                f"snapshot geometry mismatch: snapshot {got} != engine {want}"
            )
        self._reset_host()
        if int(g["ring_steps"]) > self._ring_steps:
            self._grow_ring(int(g["ring_steps"]))
        now = time.perf_counter()
        try:
            # the snapshot's arrays in the order of _slot_views
            names = [f"state{i}_{k}" for i in range(self.cfg.num_layers)
                     for k in ("u", "refrac")]
            names += [f"ring_{k}" for k in ("addrs", "values", "counts")]
            names += [f"meta_{k}" for k in ("done", "total", "admit", "fault")]
            r = arrays["ring_counts"].shape[1]
            for sh in self._shards:
                for buf in sh._ring.values():
                    buf[:, r:].zero_()
            for s in range(self.S):
                rows = [arrays[k][s:s + 1] for k in names]
                self._put_rows(s, list(zip(self._slot_views(s, r), rows)))
            if "rng_state" in arrays:
                self._gen.set_state(torch.from_numpy(arrays["rng_state"]))
            else:
                self._gen.manual_seed(_seed_from_key(arrays["rng_key"]))
            self._slot_done = arrays["slot_done"].astype(np.int64)
            self._slot_retired = arrays["slot_retired"].astype(np.int64)
            self._slot_total = arrays["slot_total"].astype(np.int64)
            self._slot_priority = arrays["slot_priority"].astype(np.int64)
            self._slot_counts = arrays["slot_counts"].astype(np.float64)
            self._slot_memsum = arrays["slot_memsum"].astype(np.float64)
            self._slot_events = arrays["slot_events"].astype(np.float64)
            for s, doc in enumerate(manifest["slots"]):
                self._slot_req[s] = doc["rid"]
                self._slot_parked[s] = bool(doc["parked"])
                self._slot_rel_deadline[s] = doc["rel_deadline"]
                rem = doc["deadline_remaining_s"]
                self._slot_deadline[s] = None if rem is None else now + rem
                self._slot_submit_t[s] = now - doc["submit_age_s"]
                self._slot_admit_t[s] = now - doc["admit_age_s"]

            def unpack_req(prefix, doc):
                kw = dict(
                    num_steps=doc["num_steps"],
                    deadline_s=doc["deadline_s"],
                    priority=doc["priority"],
                )
                if f"{prefix}_spikes" in arrays:
                    req = StreamRequest(spikes=arrays[f"{prefix}_spikes"], **kw)
                else:
                    req = StreamRequest(image=arrays[f"{prefix}_image"], **kw)
                rem = doc["deadline_remaining_s"]
                dl = None if rem is None else now + rem
                return req, now - doc["submit_age_s"], dl

            for i, doc in enumerate(manifest["queue"]):
                req, t_sub, dl = unpack_req(f"q{i}", doc)
                key = (
                    -int(req.priority),
                    0 if dl is not None else 1,
                    dl if dl is not None else 0.0,
                    doc["seq"],
                )
                heapq.heappush(self._queue, (key, doc["rid"], req, t_sub, dl))
            for i, doc in enumerate(manifest["parked"]):
                req, t_sub, dl = unpack_req(f"p{i}", doc)
                self._parked.append((doc["rid"], req, t_sub, dl))
            n_layers = self.cfg.num_layers
            for i, doc in enumerate(manifest["preempt_parked"]):
                rem = doc["deadline_remaining_s"]
                self._preempt_parked.append({
                    "rid": doc["rid"],
                    "priority": int(doc["priority"]),
                    "done": int(doc["done"]),
                    "total": int(doc["total"]),
                    "parked": bool(doc["parked"]),
                    "ring_steps": int(doc["ring_steps"]),
                    "rel_deadline": doc["rel_deadline"],
                    "abs_deadline": None if rem is None else now + rem,
                    "t_submit": now - doc["submit_age_s"],
                    "t_admit": now - doc["admit_age_s"],
                    "u": [arrays[f"pp{i}_u{j}"] for j in range(n_layers)],
                    "refrac": [
                        arrays[f"pp{i}_refrac{j}"] for j in range(n_layers)
                    ],
                    "ring_addrs": arrays[f"pp{i}_ring_addrs"],
                    "ring_values": arrays[f"pp{i}_ring_values"],
                    "ring_counts": arrays[f"pp{i}_ring_counts"],
                    "counts": arrays[f"pp{i}_counts"],
                    "memsum": arrays[f"pp{i}_memsum"],
                    "events": arrays[f"pp{i}_events"],
                })
        except KeyError as e:
            raise CheckpointCorruptError(
                f"array {e} missing from snapshot {path}"
            ) from e
        self._pending_results = [
            _undoc_result(d) for d in manifest["pending_results"]
        ]
        self.fault_events = list(manifest["fault_events"])
        self._tick_index = int(manifest["tick_index"])
        self._seq = int(manifest["seq"])
        self._next_rid = int(manifest["next_rid"])
        self._snap_index = int(manifest.get("snap_index", 0))
        self._m_qdepth.set(len(self._queue))
        self._m_parked_depth.set(len(self._parked))
        self._m_preempt_depth.set(len(self._preempt_parked))
        if not self.idle():
            self._episode_open = True
            self._episode_t0 = now - float(manifest.get("episode_age_s", 0.0))
        t_end = time.perf_counter()
        self._m_restore_snap_time.record(t_end - t_start)
        backend = manifest.get("backend")
        self.trace.span(
            "restore", t_start, t_end, track="engine",
            args={"path": path, "tick": self._tick_index,
                  "backend": "torch" if backend == "jnp" else backend},
        )

    def snapshot_auto(self, directory: str, keep_n: int = 3) -> str:
        """Write the next snapshot of a keep-N rotation under
        ``directory`` (``snap_NNNNNN``), pruning the oldest beyond
        ``keep_n``; orphaned ``.tmp_*`` dirs of a killed writer are
        garbage-collected first."""
        os.makedirs(directory, exist_ok=True)
        gc_orphan_tmpdirs(directory)
        self._snap_index += 1
        out = self.snapshot(
            os.path.join(directory, f"snap_{self._snap_index:06d}")
        )
        names = sorted(
            d for d in os.listdir(directory) if d.startswith("snap_")
        )
        for d in names[:-keep_n] if keep_n else []:
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)
        return out

    def restore_latest_snapshot(self, directory: str) -> Optional[str]:
        """Restore the newest snapshot under ``directory`` that passes its
        integrity check.  A corrupt one (truncated npz, checksum mismatch)
        is skipped with a loud warning and the
        ``engine.faults.checkpoint_fallback`` counter, falling back to the
        previous one.  Returns the restored path, or None when no usable
        snapshot exists."""
        if not os.path.isdir(directory):
            return None
        gc_orphan_tmpdirs(directory)
        names = sorted(
            (
                d for d in os.listdir(directory)
                if d.startswith("snap_")
                and os.path.exists(os.path.join(directory, d, "manifest.json"))
            ),
            reverse=True,
        )
        for name in names:
            p = os.path.join(directory, name)
            try:
                self.restore(p)
                return p
            except CheckpointCorruptError as e:
                self._m_ckpt_fallback.inc()
                warnings.warn(
                    f"engine snapshot {p} failed integrity check ({e}); "
                    f"falling back to the previous snapshot",
                    stacklevel=2,
                )
        return None

    # --------------------------------------------------------- scheduler
    def idle(self) -> bool:
        """True when nothing is queued, parked (admission plane or
        preemption buffer), resident, in flight or undelivered."""
        return (
            not self._queue
            and not self._parked
            and not self._preempt_parked
            and all(r is None for r in self._slot_req)
            and not self._inflight
            and not self._pending_results
        )

    def queue_depth(self) -> int:
        return len(self._queue)

    def parked_depth(self) -> int:
        return len(self._parked)

    def preempt_parked_depth(self) -> int:
        """Occupancy of the preemption buffer (displaced mid-window slots
        awaiting resume)."""
        return len(self._preempt_parked)

    def _fill_slot(self, s: int) -> None:
        """Admit into free slot ``s``: resume the most urgent
        preempt-parked window when it beats (or ties) the queue head (a
        started window wins ties, avoiding swap thrash), else pop the heap
        in priority/EDF order, shedding (or parking) candidates the
        feasibility check proves unmeetable, then fall back to the parked
        FIFO when the heap empties (best-effort service, marked ``parked``
        on the result)."""
        while True:
            best = self._best_preempt_key()
            if best is not None and (
                not self._queue or best[0] <= self._queue[0][0][:3]
            ):
                self._resume_slot(s, self._preempt_parked.pop(best[1]))
                return
            if not self._queue:
                break
            _, rid, req, t_sub, dl = heapq.heappop(self._queue)
            verdict, reason = self._admission_verdict(req, dl)
            if verdict == shed_mod.ADMIT:
                self._admit(s, rid, req, t_sub, dl)
                return
            if verdict == shed_mod.PARK:
                self._park(rid, req, t_sub, dl, reason)
            else:
                self._shed(rid, req, t_sub, dl, reason)
        if self._parked:
            rid, req, t_sub, dl = self._parked.popleft()
            self._m_parked_depth.set(len(self._parked))
            self._admit(s, rid, req, t_sub, dl)
            self._slot_parked[s] = True

    def poll(self) -> List[StreamResult]:
        """One scheduler round: preempt if a more urgent request waits,
        fill free slots (priority/EDF order, feasibility shedding under an
        admission policy), dispatch the next chunk, retire pipelined
        stats, and return the requests that finished, shed and
        quarantined ones included."""
        self._maybe_preempt()
        for s in range(self.S):
            if self._slot_req[s] is None and (
                self._queue or self._parked or self._preempt_parked
            ):
                self._fill_slot(s)
        self._m_qdepth.set(len(self._queue))
        if all(r is None for r in self._slot_req) and not self._inflight:
            results, self._pending_results = self._pending_results, []
            if results and self.idle() and self._episode_open:
                self._m_wall.set(time.perf_counter() - self._episode_t0)
                self._episode_open = False
            if results:
                self.timeseries.sample()
            return results
        results = [self._finalize(s) for s in self._tick()]
        if self._pending_results:
            results = self._pending_results + results
            self._pending_results = []
        if self.idle() and self._episode_open:
            self._m_wall.set(time.perf_counter() - self._episode_t0)
            self._episode_open = False
        # one time-series point per tick, after completions land
        self.timeseries.sample()
        return results

    def drain(self, timeout_s: Optional[float] = None) -> List[StreamResult]:
        """Poll until idle; returns results in completion order.  Raises
        ``EngineStallError`` with a per-slot ``stall_snapshot()`` if
        ``timeout_s`` expires first."""
        results: List[StreamResult] = []
        t0 = time.perf_counter()
        while not self.idle():
            results.extend(self.poll())
            if (
                timeout_s is not None
                and time.perf_counter() - t0 > timeout_s
                and not self.idle()
            ):
                snap = self.stall_snapshot()
                stuck = [
                    d["slot"] for d in snap["slots"] if d["rid"] is not None
                ]
                raise EngineStallError(
                    f"drain() timed out after {timeout_s}s with the "
                    f"engine not idle: queue={snap['queue_depth']} "
                    f"parked={snap['parked_depth']} "
                    f"preempt_parked={snap['preempt_parked_depth']} "
                    f"inflight={snap['inflight']} "
                    f"stuck_slots={stuck}",
                    snap,
                    results,
                )
        return results

    def stall_snapshot(self) -> Dict:
        """Diagnostic view of everything that could be blocking progress:
        per-slot occupancy (request id, steps dispatched / retired /
        total, deadline, parked flag), queue and parked depths with the
        parked request ids and the preemption buffer, in-flight stats
        chunks and the tick index."""
        return {
            "tick": self._tick_index,
            "queue_depth": len(self._queue),
            "parked_depth": len(self._parked),
            "parked_rids": [rid for rid, _, _, _ in self._parked],
            "preempt_parked_depth": len(self._preempt_parked),
            "preempt_parked": [
                {
                    "rid": rec["rid"],
                    "priority": rec["priority"],
                    "done": rec["done"],
                    "total": rec["total"],
                    "deadline_s": rec["rel_deadline"],
                }
                for rec in self._preempt_parked
            ],
            "inflight": len(self._inflight),
            "pending_results": len(self._pending_results),
            "backend": self.backend,
            "slots": [
                {
                    "slot": s,
                    "rid": self._slot_req[s],
                    "done": int(self._slot_done[s]),
                    "retired": int(self._slot_retired[s]),
                    "total": int(self._slot_total[s]),
                    "deadline_s": self._slot_rel_deadline[s],
                    "parked": self._slot_parked[s],
                }
                for s in range(self.S)
            ],
        }

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
        ev = self.total_events - self._m_q_events.value
        return max(ev, 0.0) / max(denom, 1e-9)

    def deadline_miss_rate(self) -> float:
        """Fraction of this episode's ok completions that missed their
        deadline (requests without a deadline count as met)."""
        return self.deadline_misses / max(self.completed, 1)

    def shed_rate(self) -> float:
        """Lifetime fraction of submitted requests the admission plane
        shed (parked requests are served best-effort, not shed).  0.0
        with no admission policy."""
        return self._m_shed.value / max(self._m_submitted.value, 1.0)

    def reset_tick_stats(self) -> None:
        """Zero the tick-phase instruments (e.g. after a warm-up episode,
        so ``tick_breakdown`` reflects steady state, not the first tick's
        kernel build and graph capture)."""
        self.metrics.reset(prefix="engine.tick.")

    def tick_breakdown(self) -> Dict[str, float]:
        """Engine-lifetime mean per-tick timing from the ``engine.tick.*``
        histograms' exact sums.

        ``host_prep_us`` is host scheduling work.  ``dispatch_us`` is the
        time spent issuing the chunk: a graph replay and the stats copy's
        enqueue on the card (the card runs it asynchronously), the whole
        eager chunk on the CPU.  ``stats_fetch_us`` is the blocking stats
        retirement (any remaining device wait, the single D2H read, and
        folding)."""
        n = max(self._m_prep.count, 1)
        return {
            "ticks": self._m_prep.count,
            "pipeline_depth": self.pipeline_depth,
            "host_prep_us": self._m_prep.sum / n * 1e6,
            "dispatch_us": self._m_dispatch.sum / n * 1e6,
            "stats_fetch_us": self._m_fetch.sum / n * 1e6,
            "dispatch_p99_us": self._m_dispatch.percentile(99) * 1e6,
        }

    # -------------------------------------------------------- benchmarks
    def _unsharded(self, what: str) -> _SlotShard:
        if len(self._shards) != 1:
            raise ValueError(
                f"{what} times the unsharded chunk; this engine has "
                f"{len(self._shards)} slot shards"
            )
        return self._shards[0]

    def staged_chunk_args(self, trains: Sequence[np.ndarray]):
        """Stage ``trains`` (one per slot, (T, K) each) into fresh state,
        ring and metadata buffers and return ``(prepared, states, ring,
        meta)``, the arguments of ``chunk_for_timing()``.  Measures the
        resident chunk as the tick loop runs it, without touching the
        live engine.  An unsharded engine's only."""
        sh = self._unsharded("staged_chunk_args")
        if len(trains) != self.S:
            raise ValueError(f"need {self.S} trains, got {len(trains)}")
        dev = sh.device
        states = runtime.init_states(self.cfg, self.S, device=dev)
        ring = self._alloc_ring(
            max(self._ring_steps, max(t.shape[0] for t in trains)), self.S,
            dev)
        meta = {
            k: torch.zeros((self.S,), dtype=torch.int32, device=dev)
            for k in ("done", "total", "admit", "fault")
        }
        for s, t in enumerate(trains):
            train = torch.from_numpy(np.asarray(t, np.float32)).to(dev)
            self._stage(ring, meta, sh._slot_ids[s:s + 1], train)
        meta["admit"].zero_()
        return sh._prepared, states, ring, meta

    def _chunk_on_copies(self, prepared, states, ring, meta):
        """``_chunk`` on copies of ``states`` and ``meta`` into a new
        stats vector: ``(new_states, new_meta, stats)``; writes nothing it
        was given."""
        NL, L = self.cfg.layer_sizes[-1], self.cfg.num_layers
        n = meta["done"].shape[0]
        new_states = [
            neuron.NeuronState(st.u.clone(), st.refrac.clone())
            for st in states
        ]
        new_meta = {k: v.clone() for k, v in meta.items()}
        stats = torch.empty((2 * n * NL + n * L + n,), dtype=torch.float32,
                            device=meta["done"].device)
        self._chunk(prepared, new_states, ring, new_meta, stats)
        return new_states, new_meta, stats

    def chunk_for_timing(self):
        """The eager chunk that writes nothing it was given: each call
        runs ``_chunk`` on copies of ``states`` and ``meta`` and returns
        ``(new_states, new_meta, stats)``, so it may run repeatedly on the
        same arguments.  The tick loop itself writes into the engine's
        static buffers (through the graph, on the card).  An unsharded
        engine's only."""
        self._unsharded("chunk_for_timing")
        return self._chunk_on_copies
