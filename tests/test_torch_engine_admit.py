"""The engine's admission on the CPU: ``_stage`` over a device slot index
against the staging it replaced, bit for bit; the split rate coding; the
engine against the reference engine across a ring growth; snapshot,
restore, park and resume with the new staging; and the admission graphs'
bookkeeping (one capture per (kind, T) at a ring size, dropped by
``_grow_ring``) with stand-in graphs that replay eagerly, since the CPU
has no CUDA graphs."""

import numpy as np
import pytest
import torch

from _torch_parity import params_pair, port_cfg, spikes
from repro.core import snn as ref_snn
from repro.serving import snn_engine as ref_engine
from repro_torch.analysis import (
    RecompileDetector,
    donation_report,
    runtime_donation_check,
)
from repro_torch.core import coding
from repro_torch.serving import snn_engine as engine

REF_CFG = ref_snn.SNNConfig(layer_sizes=(64, 24, 2), num_steps=20)
K = REF_CFG.layer_sizes[0]


def _engine(**kw):
    kw = {"num_slots": 3, "chunk_steps": 5, "seed": 0, **kw}
    _, port_p = params_pair(REF_CFG, seed=0)
    return engine.SNNStreamEngine(port_p, port_cfg(REF_CFG), device="cpu",
                                  **kw)


def _old_stage(eng, ring, meta, s, train):
    """The staging this engine ran before its slot became a device index:
    host-int row writes of the packed table and the metadata."""
    from repro_torch.events import runtime

    T = train.shape[0]
    table = runtime.encode_step_table(train, eng.C, addr_dtype=eng._addr_dtype)
    ring["addrs"][s, :T] = table.addrs
    ring["values"][s, :T] = table.values
    ring["counts"][s, :T] = table.counts
    meta["done"][s] = 0
    meta["total"][s] = T
    meta["admit"][s] = 1
    if not eng.fault_checks:
        meta["fault"][s] = 0
        return
    over = torch.any(torch.sum(train != 0, dim=-1) > eng.C)
    meta["fault"][s] = over.to(torch.int32) * engine.FAULT_CAPACITY_OVERFLOW


def _noisy_buffers(eng, seed):
    """Copies of the engine's ring and metadata filled with noise, so rows
    a staging must not touch hold something to keep."""
    g = torch.Generator().manual_seed(seed)
    ring = {k: torch.randint(-100, 100, v.shape, generator=g).to(v.dtype)
            for k, v in eng._ring.items()}
    meta = {k: torch.randint(0, 50, v.shape, generator=g).to(v.dtype)
            for k, v in eng._meta.items()}
    return ring, meta


@pytest.mark.parametrize("kind", ["spikes", "image"])
@pytest.mark.parametrize("fault_checks", [True, False])
@pytest.mark.parametrize("overflow", [False, True])
def test_stage_equals_the_host_index_staging_bit_for_bit(kind, fault_checks,
                                                         overflow):
    eng = _engine(capacities=(16, 24), fault_checks=fault_checks)
    rng = np.random.default_rng(7)
    T, s = 13, 1
    rate = 0.6 if overflow else 0.1  # 0.6 x 64 inputs overflow C = 16
    if kind == "spikes":
        x = torch.from_numpy(spikes(rng, (T, K), rate, signed=True))
        u = None
        train = x
    else:
        x = torch.from_numpy(np.full(K, rate, np.float32))
        u = torch.from_numpy(rng.random((T, K), dtype=np.float32))
        train = coding.rate_code(x, u)
    want_ring, want_meta = _noisy_buffers(eng, 3)
    got_ring = {k: v.clone() for k, v in want_ring.items()}
    got_meta = {k: v.clone() for k, v in want_meta.items()}
    _old_stage(eng, want_ring, want_meta, s, train)
    eng._stage(got_ring, got_meta, eng._slot_ids[s:s + 1], x, uniforms=u)
    for k in want_ring:  # every row, those past T and other slots' too
        assert torch.equal(got_ring[k], want_ring[k]), k
    for k in want_meta:
        assert torch.equal(got_meta[k], want_meta[k]), k
    fault = int(got_meta["fault"][s])
    assert fault == (engine.FAULT_CAPACITY_OVERFLOW
                     if overflow and fault_checks else 0)
    # the untouched rows really were kept: the noise is still there
    assert torch.equal(got_ring["counts"][s, T:],
                       _noisy_buffers(eng, 3)[0]["counts"][s, T:])


@pytest.mark.parametrize("shape", [(25, 64), (7, 4, 9), (1, 3)])
@pytest.mark.parametrize("seed", [0, 11])
def test_split_rate_encode_equals_the_old_one(shape, seed):
    x = torch.from_numpy(
        np.random.default_rng(seed).random(shape[1:], dtype=np.float32) * 1.4
        - 0.2)
    T = shape[0]
    g_old = torch.Generator().manual_seed(seed)
    u_old = torch.rand((T,) + tuple(x.shape), generator=g_old,
                       dtype=torch.float32)
    old = (u_old < torch.clamp(x, 0.0, 1.0)).to(torch.float32)
    new = coding.rate_encode(torch.Generator().manual_seed(seed), x, T)
    assert new.dtype == torch.float32 and torch.equal(new, old)
    out = torch.empty((T,) + tuple(x.shape))
    got = coding.rate_uniforms(torch.Generator().manual_seed(seed), out.shape,
                               out=out)
    assert got is out and torch.equal(out, u_old)
    assert torch.equal(coding.rate_code(x, out), old)


def test_engine_equals_the_reference_across_a_ring_growth():
    """Ragged windows, then windows longer than the ring: the port's
    staging grows the ring mid-run and every request equals the
    reference engine's."""
    rng = np.random.default_rng(21)
    steps = [20, 9, 14, 32, 5, 27, 20, 40, 12]
    trains = [spikes(rng, (T, K), 0.3) for T in steps]
    ref_p, _ = params_pair(REF_CFG, seed=0)
    for backend, ref_backend in (("torch", "jnp"), ("fused", "fused")):
        want = ref_engine.SNNStreamEngine(
            ref_p, REF_CFG, num_slots=3, chunk_steps=5, backend=ref_backend,
        ).run([ref_engine.StreamRequest(spikes=x, num_steps=x.shape[0])
               for x in trains])
        eng = _engine(backend=backend)
        got = eng.run([engine.StreamRequest(spikes=x, num_steps=x.shape[0])
                       for x in trains])
        assert eng._ring_steps == 40
        assert eng._ring["counts"].shape[1] == 40 + eng.Tc
        for a, b in zip(got, want):
            assert a.disposition == b.disposition == "ok"
            assert a.steps == b.steps and a.prediction == b.prediction
            np.testing.assert_array_equal(a.spike_counts, b.spike_counts)
            np.testing.assert_array_equal(a.events_per_layer,
                                          b.events_per_layer)
            np.testing.assert_allclose(a.energy_pj, b.energy_pj, rtol=1e-9)


def _fields(r):
    return (r.request_id, r.prediction, r.steps, r.spike_rate, r.energy_pj,
            r.spike_counts.tolist(), r.events_per_layer.tolist(),
            r.disposition, r.fault, r.parked)


def _mixed(rng):
    """Image and spike requests with ragged windows."""
    out = []
    for i, T in enumerate([20, 11, 20, 6, 17, 20, 9]):
        if i % 2:
            out.append(engine.StreamRequest(image=rng.random(K, np.float32),
                                            num_steps=T))
        else:
            out.append(engine.StreamRequest(spikes=spikes(rng, (T, K), 0.3),
                                            num_steps=T))
    return out


def test_snapshot_restore_stays_bit_exact_with_the_new_staging(tmp_path):
    reqs = _mixed(np.random.default_rng(4))
    want = [_fields(r) for r in _engine().run(reqs)]
    eng1 = _engine()
    for r in reqs:
        eng1.submit(r)
    early = eng1.poll() + eng1.poll()
    path = eng1.snapshot(str(tmp_path / "snap"))
    ring = {k: v.clone() for k, v in eng1._ring.items()}
    eng2 = _engine(seed=99)  # the snapshot's generator state wins
    eng2.restore(path)
    for k in ring:  # the whole ring, stale rows past each window included
        assert torch.equal(eng2._ring[k], ring[k]), k
    got = sorted(early + eng2.drain(), key=lambda r: r.request_id)
    assert [_fields(r) for r in got] == want


def test_park_and_resume_stay_bit_exact_with_the_new_staging():
    rng = np.random.default_rng(5)
    loose = [engine.StreamRequest(spikes=spikes(rng, (20, K), 0.3),
                                  deadline_s=1e4) for _ in range(3)]
    tight = engine.StreamRequest(image=rng.random(K, np.float32),
                                 num_steps=5, priority=5, deadline_s=0.5)

    def run(eng):
        for r in loose:
            eng.submit(r)
        out = eng.poll()
        eng.submit(tight)
        while not eng.idle():
            out += eng.poll()
        return sorted(out, key=lambda r: r.request_id)

    plain = run(_engine())
    eng = _engine(preempt=True)
    got = run(eng)
    assert eng.metrics_snapshot()["engine.preempt.parked"]["value"] >= 1
    # the image request draws the same uniforms in both runs: equal
    assert [_fields(r) for r in got] == [_fields(r) for r in plain]


class _EagerGraph:
    """A stand-in for an admission graph on the CPU: its replay runs the
    staging over the static inputs and the ring and metadata it was
    captured against, as a real graph holds their addresses."""

    def __init__(self, eng, ins):
        ring, meta = eng._ring, eng._meta
        self.replay = lambda: eng._stage(ring, meta, ins["slot"], ins["x"],
                                         uniforms=ins.get("uniforms"))


def _graphed_on_cpu(monkeypatch, eng):
    """Run ``eng``'s graphed paths on the CPU with stand-in graphs that
    replay eagerly (the chunk's graph as well), counted as captures."""
    def capture_chunk():
        ring, meta = eng._ring, eng._meta
        eng._graph = type("G", (), {"replay": staticmethod(
            lambda: eng._chunk(eng._prepared, eng._states, ring, meta,
                               eng._stats))})()
        eng.graph_captures += 1
        eng._note_captures()

    monkeypatch.setattr(eng, "_capture", capture_chunk)
    monkeypatch.setattr(eng, "_capture_stage",
                        lambda ins: _EagerGraph(eng, ins))
    eng.graphed = True
    return eng


def test_admission_graphs_count_signatures_and_recapture_after_growth(
        monkeypatch):
    """One capture per (kind, T) at a ring size; ``_grow_ring`` drops them
    and the next admission of each signature captures once more, within
    the contract; results equal the eager engine's, images included."""
    rng = np.random.default_rng(8)
    first = _mixed(rng)  # (spikes, 20/6/17/9) and (image, 11/20)
    longer = [engine.StreamRequest(spikes=spikes(rng, (30, K), 0.3),
                                   num_steps=30)]
    again = first[:4]
    want = [_fields(r) for r in _engine().run(first + longer + again)]
    eng = _graphed_on_cpu(monkeypatch, _engine())
    with RecompileDetector() as det:
        det.track("engine", eng, allowed=1)  # the chunk's cold start
        got = [_fields(r) for r in eng.run(first)]
        sigs = {("spikes" if r.spikes is not None else "image", r.num_steps)
                for r in first}
        assert eng.admit_captures == len(sigs) == 6
        assert set(eng._admit_graphs) == sigs
        assert eng.admit_replays == len(first)
        got += [_fields(r) for r in eng.run(longer)]  # grows: drops them
        assert eng._ring_steps == 30
        assert set(eng._admit_graphs) == {("spikes", 30)}
        got += [_fields(r) for r in eng.run(again)]
        # each signature of ``again`` captured once more, at the new size
        assert eng.admit_captures == 6 + 1 + len(
            {("spikes" if r.spikes is not None else "image", r.num_steps)
             for r in again})
    assert [(a[1:]) for a in got] == [(b[1:]) for b in want]
    assert eng.admit_replays == len(first) + len(longer) + len(again)
    assert eng.steady_state_recompiles() == 0
    assert det.unexpected() == [] and det.cache_growth("engine") == (
        eng.admit_captures + eng.graph_captures)
    assert eng.graph_captures == 2  # cold start, then the ring growth


def test_a_second_capture_of_one_signature_is_a_recapture(monkeypatch):
    eng = _graphed_on_cpu(monkeypatch, _engine())
    reqs = _mixed(np.random.default_rng(9))[:2]
    eng.run(reqs)
    assert eng.steady_state_recompiles() == 0
    eng._admit_graphs.clear()  # dropped without a ring growth
    eng.run(reqs)
    assert eng.steady_state_recompiles() == 2
    assert eng.health()["diagnosis"]["steady_state_recompiles"] == 2


def test_uniforms_drawn_outside_the_graph_follow_the_eager_draws(monkeypatch):
    """An image admitted through the graph path draws its uniforms into
    the static buffer from the engine's generator: the generator ends
    where the eager engine's does, so later images draw alike too."""
    reqs = [engine.StreamRequest(image=np.full(K, 0.3, np.float32),
                                 num_steps=T) for T in (20, 20, 8)]
    eager = _engine()
    eager.run(reqs)
    eng = _graphed_on_cpu(monkeypatch, _engine())
    eng.run(reqs)
    assert torch.equal(eng._gen.get_state(), eager._gen.get_state())
    assert eng.admit_captures == 2 and eng.admit_replays == 3


def test_demotion_drops_the_admission_graphs(monkeypatch):
    eng = _graphed_on_cpu(monkeypatch, _engine())
    eng.run(_mixed(np.random.default_rng(10))[:2])
    assert eng._admit_graphs
    eng._demote()
    assert not eng.graphed and eng._admit_graphs == {}
    before = eng.admit_replays
    eng.run(_mixed(np.random.default_rng(10))[:2])
    assert eng.admit_replays == before  # staged eagerly now


def test_stage_declares_and_keeps_its_donation_contract():
    """The reference donates the ring and the metadata to its jitted
    stage; the port's ``_stage`` updates both in place and leaves the
    slot index and the train as they were."""
    eng = _engine()
    x = torch.from_numpy(spikes(np.random.default_rng(2), (9, K), 0.3))
    slot = eng._slot_ids[2:3]
    args = (eng._ring, eng._meta, slot, x)
    assert donation_report(eng._stage, *args)["donated_argnums"] == [0, 1]
    x0 = x.clone()
    runtime_donation_check(eng._stage, args, donated=[0, 1])
    assert torch.equal(x, x0) and slot.tolist() == [2]
    assert int(eng._meta["total"][2]) == 9 and int(eng._meta["admit"][2]) == 1
