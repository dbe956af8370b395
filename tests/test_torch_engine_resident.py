"""Port parity: the engine's static chunk buffers, its single stats read
per tick, its re-capture count and its instruments, on the CPU, against
the reference engine where the reference has the same thing.

On the CPU the engine runs the same in-place chunk that the card captures
as a CUDA graph, so these tests hold the in-place semantics; the graph
itself is held by ``tests/test_torch_kernels_cuda.py`` on the card."""

import numpy as np
import pytest
import torch

from _torch_parity import params_pair, port_cfg, spikes
from repro.core import snn as ref_snn
from repro.obs import slo as ref_slo
from repro.serving import snn_engine as ref_engine
from repro_torch.obs import STATUS_CODES, default_slos
from repro_torch.serving import snn_engine as engine

REF_CFG = ref_snn.SNNConfig(layer_sizes=(64, 24, 2), num_steps=20)
STEPS = [20, 13, 7, 20, 17, 5, 11]  # ragged windows, more requests than slots


def _trains(seed=0, steps=STEPS):
    rng = np.random.default_rng(seed)
    return [spikes(rng, (T, 64), 0.3) for T in steps]


def _engine(**kw):
    _, port_p = params_pair(REF_CFG, seed=0)
    kw = {"num_slots": 3, "chunk_steps": 5, "device": "cpu", **kw}
    return engine.SNNStreamEngine(port_p, port_cfg(REF_CFG), **kw)


def _ref_engine(**kw):
    ref_p, _ = params_pair(REF_CFG, seed=0)
    kw = {"num_slots": 3, "chunk_steps": 5, "backend": "jnp", **kw}
    return ref_engine.SNNStreamEngine(ref_p, REF_CFG, **kw)


def _requests(mod, trains, **kw):
    return [mod.StreamRequest(spikes=x, num_steps=x.shape[0], **kw)
            for x in trains]


def _chunk_buffers(eng):
    """data_ptr of every input and output of the chunk, by name."""
    out = {f"u{i}": st.u for i, st in enumerate(eng._states)}
    out.update({f"refrac{i}": st.refrac for i, st in enumerate(eng._states)})
    out.update({f"meta.{k}": v for k, v in eng._meta.items()})
    out.update({f"ring.{k}": v for k, v in eng._ring.items()})
    out["stats"] = eng._stats
    out.update({f"host{i}": h for i, h in enumerate(eng._host_stats)})
    return {k: v.data_ptr() for k, v in out.items()}


# ------------------------------------------------------- static buffers
@pytest.mark.parametrize("pipeline_depth", [0, 1])
def test_chunk_buffers_stay_put_and_move_only_on_ring_growth(pipeline_depth):
    eng = _engine(pipeline_depth=pipeline_depth)
    first = _chunk_buffers(eng)
    for req in _requests(engine, _trains()):
        eng.submit(req)
    while not eng.idle():
        eng.poll()
        assert _chunk_buffers(eng) == first
    assert eng.dispatched_ticks > 0
    # a longer window grows the ring: only the ring moves
    long = spikes(np.random.default_rng(4), (33, 64), 0.3)
    eng.submit(engine.StreamRequest(spikes=long, num_steps=33))
    eng.poll()
    now = _chunk_buffers(eng)
    moved = sorted(k for k in first if now[k] != first[k])
    assert moved == ["ring.addrs", "ring.counts", "ring.values"]
    (res,) = eng.drain()
    assert res.steps == 33 and res.events_per_layer[0] == long.sum()
    assert _chunk_buffers(eng) == now


def test_steady_state_recompiles_zero_after_ragged_windows():
    eng = _engine()
    res = eng.run(_requests(engine, _trains()))
    assert [r.steps for r in res] == STEPS
    assert eng.steady_state_recompiles() == 0
    snap = eng.metrics_snapshot()
    assert snap["engine.tick.recompiles"]["value"] == 0
    # the CPU runs the chunk eagerly: nothing is captured or replayed
    assert not eng.graphed
    assert eng.graph_captures == eng.graph_replays == 0
    assert eng.health()["diagnosis"]["steady_state_recompiles"] == 0


@pytest.mark.parametrize("pipeline_depth", [0, 1])
def test_steady_poll_reads_stats_from_the_host_once(monkeypatch,
                                                    pipeline_depth):
    """Counterpart of the reference's
    ``test_snn_resident.py::test_steady_tick_single_host_transfer``: a
    steady mid-window ``poll()`` uploads nothing and reads the stats from
    the host exactly once, at ``_fetch``; it allocates no new host stats
    buffer and moves no chunk buffer."""
    eng = _engine(num_slots=2, pipeline_depth=pipeline_depth)
    for x in _trains(steps=[20, 20]):
        eng.submit(engine.StreamRequest(spikes=x, num_steps=x.shape[0]))
    eng.poll()  # admission + the first dispatch
    eng.poll()
    before = _chunk_buffers(eng)

    fetches = []
    real_fetch = eng._fetch

    def counting_fetch(host, ready):
        fetches.append(host.data_ptr())
        return real_fetch(host, ready)

    def no_upload(*_):
        raise AssertionError("a steady tick uploaded")

    monkeypatch.setattr(eng, "_fetch", counting_fetch)
    monkeypatch.setattr(eng, "_upload", no_upload)
    monkeypatch.setattr(eng, "_stage", no_upload)
    assert eng.poll() == []
    assert len(fetches) == 1
    assert fetches[0] in [h.data_ptr() for h in eng._host_stats]
    assert _chunk_buffers(eng) == before
    monkeypatch.undo()
    assert len(eng.drain()) == 2


def test_in_place_chunk_equals_the_non_donating_twin():
    """The tick writes into the engine's buffers exactly what
    ``chunk_for_timing`` returns for the same staged input, and the twin
    leaves its arguments untouched, so repeated calls agree."""
    trains = _trains()[:3]
    eng = _engine()
    args = eng.staged_chunk_args(trains)
    prepared, states, ring, meta = args
    saved = ([st.u.clone() for st in states], {k: v.clone()
                                               for k, v in meta.items()})
    twin = eng.chunk_for_timing()
    st1, meta1, stats1 = twin(*args)
    st2, meta2, stats2 = twin(*args)
    assert torch.equal(stats1, stats2)
    for a, b in zip(saved[0], states):
        assert torch.equal(a, b.u)
    for k in meta:
        assert torch.equal(saved[1][k], meta[k])
    assert meta1["done"].tolist() == [5, 5, 5]
    assert meta1["admit"].tolist() == [0, 0, 0]

    for req in _requests(engine, trains):
        eng.submit(req)
    eng.poll()  # admits all three, dispatches one chunk in place
    assert torch.equal(eng._stats, stats1)
    for live, new in zip(eng._states, st1):
        assert torch.equal(live.u, new.u)
        assert torch.equal(live.refrac, new.refrac)
    for k in ("done", "total", "admit", "fault"):
        assert torch.equal(eng._meta[k], meta1[k])
    with pytest.raises(ValueError, match="need 3 trains"):
        eng.staged_chunk_args(trains[:2])


# ----------------------------------------------------- the instruments
@pytest.fixture(scope="module")
def engine_pair():
    """The reference engine and the port's, each after serving the same
    spike requests, with deadlines (one certain miss)."""
    trains = _trains(seed=5)
    ref = _ref_engine()
    ref.run(_requests(ref_engine, trains[:-1], deadline_s=1e4)
            + _requests(ref_engine, trains[-1:], deadline_s=0.0))
    port = _engine()
    port.run(_requests(engine, trains[:-1], deadline_s=1e4)
             + _requests(engine, trains[-1:], deadline_s=0.0))
    return ref, port


def test_metrics_snapshot_reads_the_reference_instruments(engine_pair):
    ref, port = engine_pair
    ref_snap, snap = ref.metrics_snapshot(), port.metrics_snapshot()
    assert set(snap) == set(ref_snap)
    for key in ("engine.requests.submitted", "engine.requests.completed",
                "engine.requests.deadline_missed", "engine.episode.events",
                "engine.episode.steps", "engine.episode.completed",
                "engine.episode.deadline_misses"):
        assert snap[key]["value"] == ref_snap[key]["value"], key
    assert snap["engine.episode.steps"]["value"] == sum(STEPS)
    assert snap["engine.requests.deadline_missed"]["value"] == 1
    for key, kind in ((k, v.get("type")) for k, v in ref_snap.items()):
        assert snap[key].get("type") == kind, key
    for key in ("engine.request.latency_s", "engine.request.queue_wait_s",
                "engine.request.energy_pj"):
        assert snap[key]["count"] == ref_snap[key]["count"] == len(STEPS)
    np.testing.assert_allclose(snap["engine.request.energy_pj"]["sum"],
                               ref_snap["engine.request.energy_pj"]["sum"],
                               rtol=1e-9)


def test_report_keys_match_the_reference(engine_pair):
    ref, port = engine_pair
    assert set(port.tick_breakdown()) == set(ref.tick_breakdown())
    assert port.tick_breakdown()["ticks"] == port.dispatched_ticks
    r_stall, p_stall = ref.stall_snapshot(), port.stall_snapshot()
    assert set(p_stall) == set(r_stall)
    assert set(p_stall["slots"][0]) == set(r_stall["slots"][0])
    assert p_stall["parked_rids"] == p_stall["preempt_parked"] == []
    r_health, p_health = ref.health(), port.health()
    assert set(p_health) == set(r_health)
    assert set(p_health["diagnosis"]) == set(r_health["diagnosis"])
    assert p_health["diagnosis"]["verdict"] in (
        "nominal", "breaching", "overloaded", "faulty")
    assert ([s["name"] for s in p_health["slos"]]
            == [s["name"] for s in r_health["slos"]])
    assert port.windowed_miss_rate(None) == pytest.approx(
        ref.windowed_miss_rate(None)) == pytest.approx(1 / len(STEPS))
    port.reset_tick_stats()
    assert port.tick_breakdown()["ticks"] == 0


def test_engine_span_lifecycle_invariants():
    """Port of ``tests/test_obs.py::test_engine_span_lifecycle_invariants``:
    every completed request leaves submit -> queue -> stage -> >=1 chunk
    -> complete, with monotonic timestamps ordered within the request.
    The port records no span per slot: a request's chunks are the tick
    ``dispatch`` spans that list its rid."""
    eng = _engine(num_slots=2, chunk_steps=6)
    rids = [eng.submit(engine.StreamRequest(spikes=x))
            for x in _trains(steps=[20] * 5)]
    eng.drain()
    spans = eng.trace.spans()
    assert all(s.t1 is None or s.t1 >= s.t0 for s in spans)
    dispatches = [s for s in spans if s.name == "dispatch"]
    for rid in rids:
        mine = [s for s in spans if s.args and s.args.get("rid") == rid]
        kinds = [s.name for s in mine]
        for k in ("submit", "queue", "stage", "complete"):
            assert k in kinds
        chunks = [s for s in dispatches if rid in s.args["rids"]]
        assert len(chunks) >= 1
        by = {s.name: s for s in mine}
        submit, queue = by["submit"], by["queue"]
        stage, complete = by["stage"], by["complete"]
        assert submit.t0 <= queue.t0 <= submit.t1  # submit spans entry to return
        assert queue.t0 <= queue.t1 <= stage.t0 <= stage.t1
        for c in chunks:
            assert stage.t1 <= c.t1 <= complete.t0
        assert complete.args["latency_ms"] > 0
        assert complete.args["energy_pj"] > 0
    assert any(s.track == "tick" and s.name == "dispatch" for s in spans)
    assert any(s.track == "tick" and s.name == "host_prep" for s in spans)
    assert any(s.track == "tick" and s.name == "stats_fetch" for s in spans)


def test_a_tick_records_at_most_three_spans_at_128_slots():
    """Whatever the slots, a tick records its three phase spans and no
    span per slot: the dispatch span lists every request it advanced."""
    eng = _engine(num_slots=128, chunk_steps=5)
    rids = [eng.submit(engine.StreamRequest(spikes=x))
            for x in _trains(steps=[20] * 128)]
    eng.poll()  # admits all 128 and runs the first tick
    for _ in range(2):
        before = len(eng.trace)
        eng._tick()
        added = eng.trace.spans()[before:]
        assert len(added) <= 3
        assert {s.name for s in added} == {"host_prep", "dispatch",
                                           "stats_fetch"}
    dispatch = [s for s in eng.trace.spans() if s.name == "dispatch"][-1]
    assert dispatch.args["rids"] == rids
    assert dispatch.args["steps"] == 128 * 5


def test_submit_is_one_span_without_a_sample():
    """Every submit, queued, shed or parked, records one ``submit`` span
    (entry to return) and no instrument of its own; inside an open
    episode it takes no time-series sample: the next poll's sample
    carries its counts."""
    from repro_torch import faults

    eng = _engine(num_slots=1, admission=faults.AdmissionPolicy(
        max_queue_depth=1))
    trains = _trains(steps=[20] * 5)
    eng.submit(engine.StreamRequest(spikes=trains[0]))  # opens the episode
    samples = len(eng.timeseries)
    eng.submit(engine.StreamRequest(spikes=trains[1]))  # shed: queue full
    eng.submit(engine.StreamRequest(spikes=trains[2], priority=1))  # parked
    assert len(eng.timeseries) == samples
    spans = [s for s in eng.trace.spans() if s.name == "submit"]
    assert [s.args["rid"] for s in spans] == [0, 1, 2]
    assert all(s.track == "queue" and s.t1 > s.t0 for s in spans)
    snap = eng.metrics_snapshot()
    assert snap["engine.requests.submitted"]["value"] == len(spans)
    assert not any(k.startswith("engine.submit") for k in snap)
    shed = snap["engine.requests.shed"]["value"]
    assert shed == 1
    eng.poll()
    assert len(eng.timeseries) == samples + 1
    assert eng.timeseries.window_sum("engine.requests.shed") == shed
    assert eng.timeseries.window_sum("engine.requests.submitted") == 3


def test_engine_metrics_snapshot_consistency():
    """Port of ``tests/test_obs.py::test_engine_metrics_snapshot_consistency``."""
    eng = _engine(num_slots=2)
    trains = _trains(steps=[20] * 5)
    eng.run(
        [engine.StreamRequest(spikes=x, deadline_s=1e4) for x in trains[:4]]
        + [engine.StreamRequest(spikes=trains[4], deadline_s=0.0)]
    )
    snap = eng.metrics_snapshot()
    lat = snap["engine.request.latency_s"]
    assert lat["count"] == 5
    assert 0 < lat["p50"] <= lat["p90"] <= lat["p99"]
    assert snap["engine.request.queue_wait_s"]["count"] == 5
    assert snap["engine.request.energy_pj"]["count"] == 5
    assert snap["engine.requests.completed"]["value"] == 5
    assert snap["engine.requests.deadline_missed"]["value"] == 1
    assert snap["engine.episode.deadline_misses"]["value"] == 1
    tb = eng.tick_breakdown()
    disp = snap["engine.tick.dispatch_s"]
    assert tb["ticks"] == disp["count"] > 0
    assert tb["dispatch_us"] == pytest.approx(disp["sum"] / disp["count"] * 1e6)
    assert snap["engine.request.energy_pj"]["sum"] > 0


def test_wall_s_resets_per_episode():
    """Port of ``tests/test_obs.py::test_wall_s_resets_per_episode``."""
    eng = _engine(num_slots=1)
    a, b = _trains(steps=[20, 20])
    assert eng.wall_s == 0.0
    eng.run([engine.StreamRequest(spikes=a)])
    first = eng.wall_s
    assert first > 0
    eng.submit(engine.StreamRequest(spikes=b))
    assert eng.wall_s == 0.0
    eng.poll()
    assert eng.wall_s == 0.0
    eng.drain()
    assert eng.wall_s > 0 and eng.wall_s is not first


def test_engine_health_and_series():
    """Port of ``tests/test_timeseries_slo.py::test_engine_health_and_series``,
    with the port's verdict held against the reference's SLO evaluation
    of the port engine's own series."""
    eng = _engine(num_slots=2)
    n_req = 5
    trains = _trains(steps=[20] * n_req)
    eng.run(
        [engine.StreamRequest(spikes=x, deadline_s=1e4) for x in trains[:-1]]
        + [engine.StreamRequest(spikes=trains[-1], deadline_s=0.0)]
    )
    assert len(eng.timeseries) >= n_req
    assert eng.timeseries.cum("engine.requests.completed") == n_req
    assert eng.windowed_miss_rate(None) == pytest.approx(1 / n_req)
    report = eng.health()
    assert report["status"] in STATUS_CODES
    assert {s["name"] for s in report["slos"]} == {
        "deadline_misses", "latency_p99",
    }
    dm = next(s for s in report["slos"] if s["name"] == "deadline_misses")
    assert dm["observed_error_rate"] == pytest.approx(1 / n_req)
    assert eng.metrics.gauge("engine.slo.status").value == report["status_code"]
    ref_report = ref_slo.evaluate(ref_slo.default_slos(), eng.timeseries)
    assert ref_report["status"] == report["status"]
    assert ([s["observed_error_rate"] for s in ref_report["slos"]]
            == [s["observed_error_rate"] for s in report["slos"]])
    eng2 = _engine(num_slots=2,
                   slos=default_slos(deadline_objective=0.5,
                                     p99_target_s=100.0))
    assert eng2.slos[0].budget == pytest.approx(0.5)


def test_stall_error_carries_the_snapshot():
    eng = _engine(num_slots=1, chunk_steps=20)
    x = _trains(steps=[20])[0]
    rids = [eng.submit(engine.StreamRequest(spikes=x)) for _ in range(3)]
    with pytest.raises(engine.EngineStallError) as stall:
        eng.drain(timeout_s=0.0)  # expires after the first poll
    snap = stall.value.snapshot
    assert snap == eng.stall_snapshot()
    assert snap["queue_depth"] == 2 and snap["tick"] == 1
    assert [r.request_id for r in stall.value.results] == rids[:1]
    assert snap["slots"][0]["rid"] is None
    assert "stuck_slots=[]" in str(stall.value)
    assert [r.request_id for r in eng.drain(timeout_s=60.0)] == rids[1:]


def test_quarantine_is_counted_and_traced():
    eng = _engine(num_slots=2, capacities=(40, 24))
    dense = np.ones((20, 64), np.float32)  # 64 events a step > C = 40
    res = eng.run(_requests(engine, _trains()[:2])
                  + [engine.StreamRequest(spikes=dense)])
    assert [r.disposition for r in res] == ["ok", "ok", "quarantined"]
    snap = eng.metrics_snapshot()
    assert snap["engine.requests.quarantined"]["value"] == 1
    assert snap["engine.requests.completed"]["value"] == 2
    assert eng.fault_events[0]["tick"] >= 1
    assert any(s.name == "quarantine" for s in eng.trace.spans())
    assert eng.health()["diagnosis"]["verdict"] == "faulty"
