"""The port's slot-sharded ``SNNStreamEngine(mesh=...)`` on a mesh of one
device repeated (the CPU here, the card in the ``cuda`` cases), held
against the port's own unsharded engine bit for bit and against the
reference's unsharded engine under the port's contract (the reference's
own 2-device sharded test fails on the reference, ROADMAP C1, so the
unsharded engines are the oracle).  64-24-2, 12 steps, 5 requests, as
the reference's sharded tests; the loud error for slots that do not
divide; elastic restores across 1, 2 and 4 shards; a reference snapshot
into a sharded engine; a fault and a preemption across shards; the
per-shard capture accounting with stand-in graphs.

The reference is imported inside the tests that compare with it, so the
``cuda`` cases run where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_engine_sharded.py
"""

import numpy as np
import pytest
import torch

from repro_torch.analysis.contracts import RecompileDetector
from repro_torch.core import snn
from repro_torch.distributed.partitioning import Mesh, slot_shards
from repro_torch.faults import Fault, FaultInjector, FaultSchedule
from repro_torch.serving import snn_engine as engine

CFG = snn.SNNConfig(layer_sizes=(64, 24, 2), num_steps=12)
STEPS = [12, 7, 5, 12, 9]  # ragged windows, more requests than slots
K = CFG.layer_sizes[0]


def _params(dev="cpu"):
    return snn.init_params(torch.Generator().manual_seed(0), CFG, dev)


def _trains(seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((T, K)) < 0.3).astype(np.float32) for T in STEPS]


def _requests(seed=0, images=True, **kw):
    reqs = [engine.StreamRequest(spikes=x, num_steps=x.shape[0], **kw)
            for x in _trains(seed)]
    if images:
        rng = np.random.default_rng(seed + 100)
        reqs += [engine.StreamRequest(
            image=rng.random(K).astype(np.float32), num_steps=T, **kw)
            for T in (12, 8)]
    return reqs


def _mesh(n, dev="cpu", axes=("data",)):
    return Mesh(np.array([torch.device(dev)] * n).reshape(
        (n,) if len(axes) == 1 else (n // 2, 2)), axes)


def _mk(n=None, slots=4, dev="cpu", params=None, **kw):
    return engine.SNNStreamEngine(
        params if params is not None else _params(dev), CFG,
        num_slots=slots, chunk_steps=5, device=dev,
        mesh=None if n is None else _mesh(n, dev), **kw)


def _fields(r):
    """Every field of a result but the clocks."""
    return (r.request_id, r.prediction, r.steps, r.spike_rate, r.energy_pj,
            r.spike_counts.tolist(), r.events_per_layer.tolist(),
            r.disposition, r.fault, r.parked, r.deadline_missed)


def _by_rid(results):
    return {r.request_id: r for r in results}


# ------------------------------------------------------------ parity
@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_slots_match_unsharded(shards):
    """2 and 4 slot shards of 4 slots equal the unsharded engine on every
    request, spike trains and images, bit for bit; each shard holds its
    consecutive slots."""
    want = [_fields(r) for r in _mk().run(_requests())]
    eng = _mk(shards)
    got = [_fields(r) for r in eng.run(_requests())]
    assert got == want
    n = 4 // shards
    assert [(sh.lo, sh.hi) for sh in eng._shards] == [
        (i * n, (i + 1) * n) for i in range(shards)]
    assert all(sh._ring["counts"].shape[0] == n for sh in eng._shards)
    assert eng.idle() and eng.completed == len(want)


def test_two_shards_of_two_slots_match_unsharded():
    """The reference's own case: 2 slots over a 2-device mesh."""
    want = [_fields(r) for r in _mk(slots=2).run(_requests(images=False))]
    got = [_fields(r) for r in _mk(2, slots=2).run(_requests(images=False))]
    assert got == want


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_engine_matches_the_reference_engine(shards):
    """Against the reference's unsharded engine on the same params and
    trains: spikes and events exact, predictions equal, energy within
    1e-9 relative (ROADMAP's contract for engine results)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import snn as ref_snn
    from repro.serving import snn_engine as ref_engine

    params = _params()
    ref_p = {name: {k: jnp.asarray(v.numpy()) for k, v in lp.items()}
             for name, lp in params.items()}
    ref_cfg = ref_snn.SNNConfig(layer_sizes=CFG.layer_sizes,
                                num_steps=CFG.num_steps)
    ref = ref_engine.SNNStreamEngine(ref_p, ref_cfg, num_slots=4,
                                     chunk_steps=5, backend="jnp").run(
        [ref_engine.StreamRequest(spikes=x, num_steps=x.shape[0])
         for x in _trains()])
    got = _mk(shards, params=params).run(_requests(images=False))
    assert [r.request_id for r in got] == [r.request_id for r in ref]
    for a, b in zip(got, ref):
        assert (a.disposition, a.steps, a.prediction) == (
            b.disposition, b.steps, b.prediction)
        np.testing.assert_array_equal(a.spike_counts, b.spike_counts)
        np.testing.assert_array_equal(a.events_per_layer, b.events_per_layer)
        assert a.energy_pj == pytest.approx(b.energy_pj, rel=1e-9)


def test_stats_are_assembled_in_global_slot_order():
    """One tick's host stats of a 4-shard engine equal the unsharded
    engine's, section by section; a shard's four sections are four
    copies, the unsharded engine's one."""
    rng = np.random.default_rng(4)
    trains = [(rng.random((12, K)) < 0.3).astype(np.float32)
              for _ in range(4)]
    hosts = []
    for n in (None, 4):
        eng = _mk(n, pipeline_depth=1)
        for x in trains:
            eng.submit(engine.StreamRequest(spikes=x))
        eng.poll()
        hosts.append(eng._inflight[0][0].clone())
        assert len(eng._stats_copies[0]) == (1 if n is None else 4 * n)
    assert torch.equal(hosts[0], hosts[1])
    assert hosts[0].abs().sum() > 0


# -------------------------------------------------- misconfiguration
def test_non_divisible_num_slots_raises():
    with pytest.raises(ValueError, match="num_slots=3"):
        _mk(2, slots=3)
    with pytest.raises(ValueError, match="num_slots=4"):
        engine.SNNStreamEngine(_params(), CFG, num_slots=4, chunk_steps=5,
                               mesh=Mesh([torch.device("cpu")] * 2,
                                         ("model",)))


def test_replicated_mesh_axes_compute_each_shard_once():
    """Axes outside the slot rule hold replicas: 2 x 2 (data, model)
    gives 2 shards; (pod, data) splits over both, or over a prefix."""
    cpu = torch.device("cpu")
    dm = Mesh(np.array([cpu] * 4).reshape(2, 2), ("data", "model"))
    assert [(lo, hi) for lo, hi, _ in slot_shards(4, dm)] == [(0, 2), (2, 4)]
    eng = engine.SNNStreamEngine(_params(), CFG, num_slots=4, chunk_steps=5,
                                 mesh=dm)
    assert len(eng._shards) == 2 and eng.device == cpu
    pd = Mesh(np.array([cpu] * 4).reshape(2, 2), ("pod", "data"))
    assert len(slot_shards(8, pd)) == 4
    assert [(lo, hi) for lo, hi, _ in slot_shards(2, pd)] == [(0, 1), (1, 2)]
    with pytest.raises(AttributeError, match="per shard"):
        eng._ring


def test_timing_helpers_are_unsharded_only():
    eng = _mk(2)
    with pytest.raises(ValueError, match="2 slot shards"):
        eng.chunk_for_timing()
    with pytest.raises(ValueError, match="2 slot shards"):
        eng.staged_chunk_args(_trains()[:4])
    one = _mk(1)
    states, meta, stats = one.chunk_for_timing()(
        *one.staged_chunk_args([x[:5] for x in _trains()[:4]]))
    assert stats.shape == one._stats.shape


# ------------------------------------------------------- snapshots
@pytest.mark.parametrize("src,dst", [(2, None), (None, 2), (2, 4), (4, 1)])
def test_elastic_restore_across_shard_counts(tmp_path, src, dst):
    """A snapshot taken mid-serve on one shard count restores into
    another, and the run finishes equal to the uninterrupted run, bit for
    bit (snapshots are host arrays in global slot order)."""
    want = _by_rid(_mk().run(_requests()))
    eng = _mk(src)
    for r in _requests():
        eng.submit(r)
    early = eng.poll() + eng.poll()
    assert not eng.idle()
    path = eng.snapshot(str(tmp_path / "snap"))
    surv = _mk(dst)
    surv.restore(path)
    got = _by_rid(early + surv.drain())
    assert sorted(got) == sorted(want)
    assert [_fields(got[k]) for k in sorted(got)] == [
        _fields(want[k]) for k in sorted(want)]


def test_reference_snapshot_restores_into_a_sharded_engine(tmp_path):
    """A snapshot the reference engine wrote mid-run restores into a
    2-shard port engine, which finishes with the reference's results."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import snn as ref_snn
    from repro.serving import snn_engine as ref_engine

    params = _params()
    ref_p = {name: {k: jnp.asarray(v.numpy()) for k, v in lp.items()}
             for name, lp in params.items()}
    ref_cfg = ref_snn.SNNConfig(layer_sizes=CFG.layer_sizes,
                                num_steps=CFG.num_steps)

    def ref_mk():
        return ref_engine.SNNStreamEngine(ref_p, ref_cfg, num_slots=4,
                                          chunk_steps=5, backend="jnp")

    eng = ref_mk()
    for x in _trains():
        eng.submit(ref_engine.StreamRequest(spikes=x, num_steps=x.shape[0]))
    early = eng.poll()
    path = eng.snapshot(str(tmp_path / "refsnap"))
    twin = ref_mk()
    twin.restore(path)
    ref = _by_rid(early + twin.drain())
    port = _mk(2, params=params)
    port.restore(path)
    got = _by_rid(early + port.drain())
    assert sorted(got) == sorted(ref) == list(range(len(STEPS)))
    for rid, b in ref.items():
        a = got[rid]
        assert (a.disposition, a.steps, a.prediction) == (
            b.disposition, b.steps, b.prediction)
        np.testing.assert_array_equal(a.spike_counts, b.spike_counts)
        np.testing.assert_array_equal(a.events_per_layer, b.events_per_layer)
        assert a.energy_pj == pytest.approx(b.energy_pj, rel=1e-9)


# --------------------------------------------------- faults, preemption
def test_corrupt_ring_in_shard_one_quarantines_only_its_request():
    """A corrupt ring count written into slot 3 (shard 1's second row)
    quarantines that slot's request; every other request equals the
    fault-free run."""
    want = _by_rid(_mk(2).run(_requests(images=False)))
    inj = FaultInjector(FaultSchedule(faults=(
        Fault(tick=1, kind="corrupt_ring", slot=3),)))
    eng = _mk(2, injector=inj)
    got = _by_rid(eng.run(_requests(images=False)))
    assert [rec["slot"] for rec in inj.applied] == [3]
    bad = inj.applied[0]["rid"]
    assert got[bad].disposition == "quarantined"
    assert got[bad].fault == "ring_corrupt"
    assert [e["slot"] for e in eng.fault_events] == [3]
    for rid in want:
        if rid != bad:
            assert _fields(got[rid]) == _fields(want[rid])
    assert eng._shards[1]._ring["counts"].min() == -7  # written in place


def test_preemption_across_shards_equals_the_run_without():
    """An urgent arrival with every slot busy parks the loosest window
    (slot 3, in shard 1) and resumes it later in a slot that frees first,
    in another row: every result equals the run without preemption."""
    rng = np.random.default_rng(6)
    long = [(rng.random((12, K)) < 0.3).astype(np.float32) for _ in range(4)]

    def run(eng):
        reqs = _requests(images=False, deadline_s=500.0)
        for x, dl in zip(long, (400.0, 400.0, 400.0, 500.0)):
            eng.submit(engine.StreamRequest(spikes=x, deadline_s=dl))
        out = eng.poll()
        urgent = engine.StreamRequest(spikes=_trains(7)[0], num_steps=12,
                                      priority=3, deadline_s=50.0)
        eng.submit(urgent)
        for r in reqs:
            eng.submit(r)
        out += eng.drain()
        return [_fields(r)[:-1] for r in sorted(out,
                                                 key=lambda r: r.request_id)]

    plain = run(_mk(2))
    eng = _mk(2, preempt=True)
    got = run(eng)
    assert eng.metrics_snapshot()["engine.preempt.parked"]["value"] >= 1
    parks = [x.track for x in eng.trace.spans() if x.name == "park"]
    resumes = [x.track for x in eng.trace.spans() if x.name == "resume"]
    assert parks[0] == "slot3"  # the loosest window, shard 1's second row
    assert resumes and resumes[0] != "slot3"
    assert got == plain


# ------------------------------------------- capture accounting (CPU)
class _EagerGraph:
    """A stand-in for a CUDA graph on the CPU: its replay runs the work
    the graph would hold, over the buffers it was captured against."""

    def __init__(self, fn):
        self.replay = fn


def _graphed_on_cpu(monkeypatch, eng):
    """Run ``eng``'s graphed paths on the CPU with stand-in graphs that
    replay eagerly, counted as captures, one a shard."""
    def capture_shard(sh):
        sh._graph = _EagerGraph(lambda: eng._chunk(
            sh._prepared, sh._states, sh._ring, sh._meta, sh._stats))
        eng.graph_captures += 1
        eng._note_captures()

    monkeypatch.setattr(eng, "_capture_shard", capture_shard)
    monkeypatch.setattr(eng, "_capture_stage", lambda ins: _EagerGraph(
        lambda: eng._stage(ins["ring"], ins["meta"], ins["slot"], ins["x"],
                           uniforms=ins.get("uniforms"))))
    eng.graphed = True
    return eng


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_captures_are_counted_per_shard(monkeypatch, shards):
    """One cold capture a shard, one a shard at each ring growth, one
    admission capture per (shard, kind, T) at a ring size; a second serve
    captures nothing; results equal the eager unsharded engine's."""
    reqs = _requests()
    longer = [engine.StreamRequest(spikes=_trains(3)[0].repeat(2, 0),
                                   num_steps=24)]
    want = [_fields(r)[1:] for r in _mk().run(reqs + longer + reqs)]
    eng = _graphed_on_cpu(monkeypatch, _mk(shards))
    with RecompileDetector() as det:
        det.track("engine", eng, allowed=shards)  # the cold captures
        got = [_fields(r)[1:] for r in eng.run(reqs)]
        assert eng.graph_captures == shards == eng._captures_expected
        assert eng.admit_captures == len(eng._admit_signatures)
        assert {s[0] for s in eng._admit_signatures} == set(range(shards))
        captured = eng.admit_captures
        got += [_fields(r)[1:] for r in eng.run(longer)]  # grows the rings
        assert eng.graph_captures == 2 * shards == eng._captures_expected
        assert all(set(sh._admit_graphs) <= {("spikes", 24)}
                   for sh in eng._shards)
        got += [_fields(r)[1:] for r in eng.run(reqs)]
    assert got == want
    assert eng.graph_replays == shards * eng.dispatched_ticks
    assert eng.steady_state_recompiles() == 0
    assert det.unexpected() == [] and det.cache_growth("engine") == (
        eng.graph_captures + eng.admit_captures)
    assert eng.admit_captures > captured  # the new ring captured again
    again = eng.admit_captures
    eng.run(reqs)  # every (shard, kind, T) at this ring size is known
    assert eng.admit_captures == again and eng.steady_state_recompiles() == 0


def test_demotion_demotes_every_shard(monkeypatch):
    eng = _graphed_on_cpu(monkeypatch, _mk(2))
    eng.run(_requests()[:4])
    assert all(sh._graph is not None and sh._admit_graphs
               for sh in eng._shards)
    eng._demote()
    assert eng.backend == "torch" and not eng.graphed
    assert all(sh._graph is None and not sh._admit_graphs
               for sh in eng._shards)
    assert [_fields(r)[1:] for r in eng.run(_requests())] == [
        _fields(r)[1:] for r in _mk().run(_requests())]


# ----------------------------------------------------------- the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sharded engine's graphs are "
                    "captured on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [2, 4])
def test_graphed_sharded_engine_equals_unsharded_on_card(cuda_device, shards):
    """On the card with the fused kernel: the graphed sharded engine, the
    graphed unsharded one and the eager unsharded one agree on every
    request; one tick graph a shard, each replay one kernel launch."""
    from repro_torch.kernels import snn_chunk as chunk_mod

    params = _params(cuda_device)
    want = [_fields(r)[1:] for r in _mk(
        dev=cuda_device, params=params, backend="fused",
        cuda_graph=False).run(_requests())]
    base = _mk(dev=cuda_device, params=params, backend="fused")
    assert [_fields(r)[1:] for r in base.run(_requests())] == want
    eng = _mk(shards, dev=cuda_device, params=params, backend="fused")
    chunk_mod.snn_chunk.launches = 0
    got = [_fields(r)[1:] for r in eng.run(_requests())]
    torch.cuda.synchronize()
    assert got == want
    assert eng.graphed and eng.graph_captures == shards
    assert eng.graph_launches_per_replay == 1
    assert eng.graph_replays == shards * eng.dispatched_ticks
    assert chunk_mod.snn_chunk.launches == shards  # one warm-up a capture
    assert eng.steady_state_recompiles() == 0


@pytest.mark.cuda
def test_sharded_capture_counts_on_card(cuda_device):
    """Admission captures per (shard, kind, T), a ring growth re-captures
    once a shard within the engine's own allowlist, and a second serve
    captures nothing."""
    params = _params(cuda_device)
    eng = _mk(2, dev=cuda_device, params=params, backend="fused")
    longer = [engine.StreamRequest(spikes=_trains(3)[0].repeat(2, 0),
                                   num_steps=24)]
    with RecompileDetector() as det:
        det.track("engine", eng, allowed=2)
        eng.run(_requests())
        assert eng.graph_captures == 2
        assert eng.admit_captures == len(eng._admit_signatures)
        eng.run(longer)
        assert eng.graph_captures == 4 and eng._captures_expected == 4
        eng.run(_requests())
        captured = eng.admit_captures
        eng.run(_requests())
        assert eng.admit_captures == captured
    assert det.unexpected() == [] and eng.steady_state_recompiles() == 0


@pytest.mark.cuda
def test_sharded_engine_over_distinct_cards_on_card(cuda_device, tmp_path):
    """A mesh of distinct cards (every card there is, up to 4; skipped on
    one): each shard on its own card equals the unsharded engine on the
    first, graphed, and a snapshot taken on them restores onto one."""
    n = min(4, torch.cuda.device_count())
    if n < 2:
        pytest.skip("needs two or more cards")
    from repro_torch.kernels import _build

    for i in range(n):
        with torch.cuda.device(i):
            _build.load("snn_chunk")
    params = _params(torch.device("cuda", 0))
    want = [_fields(r) for r in _mk(dev=torch.device("cuda", 0),
                                    params=params,
                                    backend="fused").run(_requests())]
    mesh = Mesh([torch.device("cuda", i) for i in range(n)], ("data",))
    eng = engine.SNNStreamEngine(params, CFG, num_slots=4, chunk_steps=5,
                                 backend="fused", mesh=mesh)
    assert [sh.device.index for sh in eng._shards] == list(range(n))
    got = [_fields(r) for r in eng.run(_requests())]
    assert got == want
    assert eng.graph_captures == n and eng.graph_replays == (
        n * eng.dispatched_ticks)
    assert eng.steady_state_recompiles() == 0
    src = engine.SNNStreamEngine(params, CFG, num_slots=4, chunk_steps=5,
                                 backend="fused", mesh=mesh)
    for r in _requests():
        src.submit(r)
    early = src.poll() + src.poll()
    path = src.snapshot(str(tmp_path / "snap"))
    one = _mk(dev=torch.device("cuda", 0), params=params, backend="fused")
    one.restore(path)
    rest = _by_rid(early + one.drain())
    assert [_fields(rest[k]) for k in sorted(rest)] == want
