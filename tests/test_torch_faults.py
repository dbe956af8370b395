"""Port parity: the fault-tolerance plane (``repro_torch.faults`` and the
engine's admission plane, quarantine, supervisor and injector hooks)
against the reference's, case by case after ``tests/test_faults.py``.

The same spike requests, made from a seed with numpy, go through the
reference engine (``backend="jnp"``, or ``"fused"`` in interpret mode)
and the port's on the CPU (``"torch"``, or ``"fused"``, whose kernel
runs its plain version on CPU tensors), each with its own injector over
the same schedule.  Per request: ``spike_counts``, ``events_per_layer``,
``prediction``, ``steps``, ``disposition``, ``fault`` and ``parked``
equal, ``energy_pj`` (priced from the events) within 1e-9 relative, and
the membrane sums the engines fold within 1e-5.  Shapes are REF_CFG's
(64-24-2, T = 20, 3 slots, Tc = 5) unless a case needs another."""

import dataclasses
import itertools
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _hypothesis_compat import given, settings, st
from _torch_parity import np_tree, params_pair, port_cfg, spikes
from repro import faults as ref_faults
from repro.core import snn as ref_snn
from repro.faults import shedding as ref_shedding
from repro.serving import snn_engine as ref_engine
from repro_torch import faults
from repro_torch.core import coding
from repro_torch.core import snn as port_snn
from repro_torch.faults import shedding
from repro_torch.serving import snn_engine as engine

REF_CFG = ref_snn.SNNConfig(layer_sizes=(64, 24, 2), num_steps=20)
TINY = ref_snn.SNNConfig(layer_sizes=(16, 8, 2), num_steps=10)
BACKENDS = {"torch": "jnp", "fused": "fused"}  # port -> reference
_PARAMS = {}


def _params(cfg):
    """(reference, port) params with equal values; the output layer's
    threshold is lowered so that it spikes and the counts compared below
    are not all zero."""
    if cfg.layer_sizes not in _PARAMS:
        tree = {n: {k: v.copy() for k, v in lp.items()}
                for n, lp in np_tree(params_pair(cfg, seed=0)[0]).items()}
        tree[f"layer{cfg.num_layers - 1}"]["threshold"][:] = 0.1
        _PARAMS[cfg.layer_sizes] = (
            {n: {k: jnp.asarray(v) for k, v in lp.items()}
             for n, lp in tree.items()},
            port_snn.params_from_numpy(tree, "cpu"),
        )
    return _PARAMS[cfg.layer_sizes]


def _engines(cfg=REF_CFG, backend="torch", ref_kw=None, port_kw=None, **kw):
    """The reference engine and the port's, with the same geometry;
    ``ref_kw``/``port_kw`` carry what differs (each its own injector)."""
    ref_p, port_p = _params(cfg)
    kw = {"num_slots": 3, "chunk_steps": 5, **kw}
    ref = ref_engine.SNNStreamEngine(
        ref_p, cfg, backend=BACKENDS[backend], **kw, **(ref_kw or {}))
    port = engine.SNNStreamEngine(
        port_p, port_cfg(cfg), backend=backend, device="cpu", **kw,
        **(port_kw or {}))
    return ref, port


def _injectors(schedule_kw=None, faults_=None):
    """A reference and a port injector over the same schedule: seeded
    (``FaultSchedule.generate`` keywords) or explicit (field dicts)."""
    if faults_ is not None:
        return tuple(
            mod.FaultInjector(mod.FaultSchedule(
                faults=tuple(mod.Fault(**f) for f in faults_)))
            for mod in (ref_faults, faults))
    return tuple(mod.FaultInjector(mod.FaultSchedule.generate(**schedule_kw))
                 for mod in (ref_faults, faults))


def _train(seed, cfg=REF_CFG, rate=0.3, T=None):
    rng = np.random.default_rng(seed)
    return spikes(rng, (T or cfg.num_steps, cfg.layer_sizes[0]), rate)


def _requests(mod, trains, **kw):
    return [mod.StreamRequest(spikes=x, **kw) for x in trains]


def _by_rid(results):
    return {r.request_id: r for r in results}


def _assert_same(ref_results, port_results):
    """Per-request parity of two result lists (any order)."""
    ref, port = _by_rid(ref_results), _by_rid(port_results)
    assert sorted(port) == sorted(ref)
    for rid, a in ref.items():
        b = port[rid]
        assert (b.disposition, b.fault, b.parked, b.prediction, b.steps) == (
            a.disposition, a.fault, a.parked, a.prediction, a.steps), rid
        np.testing.assert_array_equal(b.spike_counts, a.spike_counts)
        np.testing.assert_array_equal(b.events_per_layer, a.events_per_layer)
        assert b.energy_pj == pytest.approx(a.energy_pj, rel=1e-9, abs=0.0)
        assert b.spike_rate == pytest.approx(a.spike_rate, rel=1e-9, abs=0.0)


def _assert_memsums(ref, port):
    np.testing.assert_allclose(port._slot_memsum, ref._slot_memsum,
                               rtol=1e-5, atol=1e-5)


def _counter(eng, name):
    return eng.metrics.get(name).value


# ------------------------------------------------- admission-plane units
def test_admission_policy_validation():
    with pytest.raises(ValueError):
        faults.AdmissionPolicy(max_queue_depth=0)
    with pytest.raises(ValueError):
        faults.AdmissionPolicy(rate_window_s=0.0)
    assert faults.AdmissionPolicy().max_queue_depth is None
    assert (dataclasses.asdict(faults.AdmissionPolicy())
            == dataclasses.asdict(ref_faults.AdmissionPolicy()))
    assert (shedding.ADMIT, shedding.SHED, shedding.PARK) == (
        ref_shedding.ADMIT, ref_shedding.SHED, ref_shedding.PARK)


def test_backpressure_verdicts():
    pol = faults.AdmissionPolicy(max_queue_depth=2)
    assert faults.backpressure(
        pol, queue_depth=1, parked_depth=0, priority=0) == ("admit", None)
    assert faults.backpressure(
        pol, queue_depth=2, parked_depth=0, priority=0) == ("shed", "queue_full")
    assert faults.backpressure(
        pol, queue_depth=2, parked_depth=0, priority=1) == ("park", "queue_full")
    assert faults.backpressure(
        pol, queue_depth=2, parked_depth=2, priority=1) == ("shed", "queue_full")
    assert faults.backpressure(
        faults.AdmissionPolicy(), queue_depth=10**6, parked_depth=0,
        priority=0) == ("admit", None)


@pytest.mark.parametrize("max_queue", [None, 1, 2, 5])
def test_backpressure_equals_the_reference_on_a_grid(max_queue):
    port_pol = faults.AdmissionPolicy(max_queue_depth=max_queue)
    ref_pol = ref_faults.AdmissionPolicy(max_queue_depth=max_queue)
    for q, p, prio in itertools.product(range(7), range(7), (-1, 0, 1, 3)):
        kw = dict(queue_depth=q, parked_depth=p, priority=prio)
        assert (faults.backpressure(port_pol, **kw)
                == ref_faults.backpressure(ref_pol, **kw)), kw


def test_feasibility_verdicts():
    pol = faults.AdmissionPolicy(shed_unmeetable=True)
    common = dict(steps=20, chunk_steps=5, now=100.0)
    assert faults.feasibility(
        pol, deadline_abs=None, ticks_per_s=50.0, priority=0, **common
    ) == ("admit", None)
    assert faults.feasibility(
        pol, deadline_abs=100.1, ticks_per_s=0.0, priority=0, **common
    ) == ("admit", None)
    assert faults.feasibility(
        pol, deadline_abs=100.5, ticks_per_s=50.0, priority=0, **common
    ) == ("admit", None)
    assert faults.feasibility(
        pol, deadline_abs=100.5, ticks_per_s=2.0, priority=0, **common
    ) == ("shed", "deadline_unmeetable")
    assert faults.feasibility(
        pol, deadline_abs=100.5, ticks_per_s=2.0, priority=1, **common
    ) == ("park", "deadline_unmeetable")
    assert faults.feasibility(
        faults.AdmissionPolicy(shed_unmeetable=False),
        deadline_abs=100.5, ticks_per_s=2.0, priority=0, **common
    ) == ("admit", None)


def _feasibility_pair(policy_kw, steps, chunk, deadline, rate, prio):
    kw = dict(steps=steps, chunk_steps=chunk, deadline_abs=deadline,
              now=100.0, ticks_per_s=rate, priority=prio)
    return (faults.feasibility(faults.AdmissionPolicy(**policy_kw), **kw),
            ref_faults.feasibility(ref_faults.AdmissionPolicy(**policy_kw),
                                   **kw))


@pytest.mark.parametrize("policy_kw", [
    {}, {"shed_unmeetable": False}, {"safety": 0.5}, {"safety": 2.0},
    {"min_ticks_per_s": 10.0},
])
def test_feasibility_equals_the_reference_on_a_grid(policy_kw):
    grid = itertools.product(
        (1, 5, 19, 20, 25), (1, 5, 7), (None, 100.0, 100.05, 100.5, 103.0),
        (0.0, 1e-4, 2.0, 9.99, 50.0, 1e4), (0, 1))
    for steps, chunk, deadline, rate, prio in grid:
        port, ref = _feasibility_pair(policy_kw, steps, chunk, deadline,
                                      rate, prio)
        assert port == ref, (steps, chunk, deadline, rate, prio)
        assert shedding.eta_lower_bound_s(
            steps=steps, ticks_per_s=rate or 1.0, chunk_steps=chunk
        ) == ref_shedding.eta_lower_bound_s(
            steps=steps, ticks_per_s=rate or 1.0, chunk_steps=chunk)


@settings(max_examples=200, deadline=None)
@given(
    max_queue=st.one_of(st.none(), st.integers(1, 16)),
    queue=st.integers(0, 20), parked=st.integers(0, 20),
    priority=st.integers(-2, 3), steps=st.integers(1, 60),
    chunk=st.integers(1, 25),
    budget=st.one_of(st.none(), st.floats(0.0, 10.0)),
    rate=st.floats(0.0, 1e4), safety=st.floats(0.0, 4.0),
)
def test_admission_verdicts_equal_the_reference_property(
        max_queue, queue, parked, priority, steps, chunk, budget, rate,
        safety):
    port_pol = faults.AdmissionPolicy(max_queue_depth=max_queue,
                                      safety=safety)
    ref_pol = ref_faults.AdmissionPolicy(max_queue_depth=max_queue,
                                         safety=safety)
    kw = dict(queue_depth=queue, parked_depth=parked, priority=priority)
    assert (faults.backpressure(port_pol, **kw)
            == ref_faults.backpressure(ref_pol, **kw))
    kw = dict(steps=steps, chunk_steps=chunk, now=50.0, ticks_per_s=rate,
              priority=priority,
              deadline_abs=None if budget is None else 50.0 + budget)
    assert (faults.feasibility(port_pol, **kw)
            == ref_faults.feasibility(ref_pol, **kw))


# -------------------------------------------- payload value validation
def test_nonfinite_payloads_rejected_at_submit():
    ref, port = _engines(num_slots=1)
    img = np.full(REF_CFG.layer_sizes[0], 0.5, np.float32)
    img[3] = np.nan
    train = _train(0)
    train[2, 5] = np.nan
    for eng, mod in ((ref, ref_engine), (port, engine)):
        with pytest.raises(ValueError, match="NaN/inf"):
            eng.submit(mod.StreamRequest(image=img))
        bad = img.copy()
        bad[3] = np.inf
        with pytest.raises(ValueError, match="NaN/inf"):
            eng.submit(mod.StreamRequest(image=bad))
        with pytest.raises(ValueError, match="non-finite"):
            eng.submit(mod.StreamRequest(spikes=train))
        assert eng.idle()


def test_nan_image_regression_silent_garbage():
    """The port's rate encoder goes silently dark on a NaN pixel, as the
    reference's does (``uniform < NaN`` is False): why submit rejects
    non-finite images."""
    img = torch.full((REF_CFG.layer_sizes[0],), 0.9)
    img[7] = float("nan")
    train = coding.rate_encode(torch.Generator().manual_seed(0), img, 16)
    assert torch.isfinite(train).all()
    assert train[:, 7].sum() == 0
    assert train[:, 0].sum() > 0


# ------------------------------------------------------ slot quarantine
def test_nan_membrane_quarantines_only_faulted_slot():
    trains = [_train(i) for i in range(2)]
    f = [dict(tick=1, kind="nan_membrane", slot=0)]
    ref_inj, port_inj = _injectors(faults_=f)
    ref, port = _engines(num_slots=2, ref_kw={"injector": ref_inj},
                         port_kw={"injector": port_inj})
    r_res = ref.run(_requests(ref_engine, trains))
    p_res = port.run(_requests(engine, trains))
    _assert_same(r_res, p_res)
    assert port_inj.applied == ref_inj.applied
    bad_rid = port_inj.applied[0]["rid"]
    by_rid = _by_rid(p_res)
    assert by_rid[bad_rid].disposition == "quarantined"
    assert by_rid[bad_rid].fault == "nonfinite_state"
    _, clean = _engines(num_slots=2)
    oracle = _by_rid(clean.run(_requests(engine, trains)))
    for r in p_res:
        if r.request_id != bad_rid:
            np.testing.assert_array_equal(r.spike_counts,
                                          oracle[r.request_id].spike_counts)
    assert _counter(port, "engine.requests.quarantined") == 1
    assert port.fault_events == ref.fault_events
    assert port.fault_events[0]["code"] == 1
    assert port.completed == ref.completed == 1
    assert port.health()["diagnosis"]["verdict"] == "faulty"


def test_quarantined_slot_serves_later_requests_cleanly():
    """The freed slot is safe to re-admit into: the chunk's sanitizing
    and the admit-time zeroing make the next request equal a fault-free
    engine's."""
    ref_inj, port_inj = _injectors(
        faults_=[dict(tick=1, kind="nan_membrane", slot=0)])
    ref, port = _engines(num_slots=1, ref_kw={"injector": ref_inj},
                         port_kw={"injector": port_inj})
    out = []
    for x in (_train(0), _train(1)):
        p = port.run(_requests(engine, [x]))
        _assert_same(ref.run(_requests(ref_engine, [x])), p)
        out.append(p[0])
    r0, r1 = out
    assert r0.disposition == "quarantined" and r1.disposition == "ok"
    _, clean = _engines(num_slots=1)
    oracle = clean.run(_requests(engine, [_train(1)]))[0]
    np.testing.assert_array_equal(r1.spike_counts, oracle.spike_counts)
    np.testing.assert_array_equal(r1.events_per_layer,
                                  oracle.events_per_layer)
    assert r1.prediction == oracle.prediction


def test_corrupt_ring_quarantines():
    ref_inj, port_inj = _injectors(
        faults_=[dict(tick=1, kind="corrupt_ring", slot=0)])
    ref, port = _engines(num_slots=1, ref_kw={"injector": ref_inj},
                         port_kw={"injector": port_inj})
    r = ref.run(_requests(ref_engine, [_train(0)]))
    p = port.run(_requests(engine, [_train(0)]))
    _assert_same(r, p)
    assert p[0].disposition == "quarantined"
    assert p[0].fault == "ring_corrupt"


def test_capacity_overflow_quarantines():
    ref, port = _engines(num_slots=1, capacities=(8, 24))
    dense = np.ones((REF_CFG.num_steps, REF_CFG.layer_sizes[0]), np.float32)
    sparse = np.zeros_like(dense)
    sparse[:, :4] = 1.0
    for x, want in ((dense, "quarantined"), (sparse, "ok")):
        r = ref.run(_requests(ref_engine, [x]))
        p = port.run(_requests(engine, [x]))
        _assert_same(r, p)
        assert p[0].disposition == want
    assert _counter(port, "engine.requests.quarantined") == 1
    assert port.fault_events[0]["fault"] == "capacity_overflow"


def test_events_per_sec_excludes_quarantined_work():
    trains = [_train(i, rate=0.5) for i in range(2)]
    ref_inj, port_inj = _injectors(
        faults_=[dict(tick=2, kind="nan_membrane", slot=0)])
    ref, port = _engines(num_slots=2, ref_kw={"injector": ref_inj},
                         port_kw={"injector": port_inj})
    _assert_same(ref.run(_requests(ref_engine, trains)),
                 port.run(_requests(engine, trains)))
    q_ev = _counter(port, "engine.episode.quarantined_events")
    assert q_ev > 0
    assert q_ev == _counter(ref, "engine.episode.quarantined_events")
    assert port.events_per_sec() * max(port.wall_s, 1e-9) == pytest.approx(
        port.total_events - q_ev, rel=1e-6)


# ------------------------------------------------- supervisor / failover
def test_transient_chunk_exception_is_retried():
    f = [dict(tick=1, kind="chunk_exception", times=2)]
    ref_inj, port_inj = _injectors(faults_=f)
    retry = dict(max_retries=2, backoff_s=0.0)
    ref, port = _engines(
        num_slots=1,
        ref_kw={"injector": ref_inj, "retry": ref_faults.RetryPolicy(**retry)},
        port_kw={"injector": port_inj, "retry": faults.RetryPolicy(**retry)})
    r = ref.run(_requests(ref_engine, [_train(0)]))
    p = port.run(_requests(engine, [_train(0)]))
    _assert_same(r, p)
    assert p[0].disposition == "ok"
    assert _counter(port, "engine.faults.chunk_retries") == 2
    assert _counter(port, "engine.requests.quarantined") == 0
    assert port_inj.raised == ref_inj.raised == 2


def test_persistent_fused_failure_demotes_to_torch():
    f = [dict(tick=0, kind="chunk_exception", times=10**6,
              only_backend="fused")]
    ref_inj, port_inj = _injectors(faults_=f)
    retry = dict(max_retries=1, backoff_s=0.0)
    ref, port = _engines(
        num_slots=1, backend="fused",
        ref_kw={"injector": ref_inj, "retry": ref_faults.RetryPolicy(**retry)},
        port_kw={"injector": port_inj, "retry": faults.RetryPolicy(**retry)})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        p = port.run(_requests(engine, [_train(0)]))
    demotions = [w for w in caught
                 if issubclass(w.category, RuntimeWarning)
                 and "demoting backend fused -> torch" in str(w.message)]
    assert len(demotions) == 1
    assert port.backend == "torch" and not port.graphed
    assert port._graph is None
    assert _counter(port, "engine.faults.backend_demoted") == 1
    assert _counter(port, "engine.faults.chunk_retries") == 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        r = ref.run(_requests(ref_engine, [_train(0)]))
    _assert_same(r, p)
    _, plain = _engines(num_slots=1)
    _assert_same(plain.run(_requests(engine, [_train(0)])), p)
    assert port.health()["diagnosis"]["verdict"] == "faulty"
    assert port.health()["diagnosis"]["backend"] == "torch"


def test_persistent_torch_failure_raises_dispatch_error():
    """No fallback below the plain backend: the failure is loud."""
    f = [dict(tick=0, kind="chunk_exception", times=10**6)]
    port_inj = _injectors(faults_=f)[1]
    _, port = _engines(num_slots=1, port_kw={
        "injector": port_inj,
        "retry": faults.RetryPolicy(max_retries=1, backoff_s=0.0)})
    port.submit(engine.StreamRequest(spikes=_train(0)))
    with pytest.raises(faults.ChunkDispatchError) as err:
        port.drain()
    assert len(err.value.errors) == 2
    assert all(isinstance(e, faults.InjectedChunkError)
               for e in err.value.errors)
    assert port.dispatched_ticks == 0


@pytest.mark.parametrize("retry_on,retried", [
    ((Exception,), True),
    ((faults.InjectedChunkError,), False),
])
def test_supervisor_handles_only_its_retry_on_exceptions(retry_on, retried):
    """An exception outside ``retry_on`` propagates from the first attempt
    as raised: no retry, no demotion, the fallback never runs (the
    engine's policy on the card, where only injected faults retry)."""
    counts = {"attempts": 0, "retries": 0, "demoted": 0, "fallback": 0}

    def attempt():
        counts["attempts"] += 1
        raise RuntimeError("snn_chunk kernel launch failed: CUDA error 700")

    def fallback():
        counts["fallback"] += 1

    def on_retry(n):
        counts["retries"] += n

    def on_demote():
        counts["demoted"] += 1

    sup = faults.ChunkSupervisor(
        faults.RetryPolicy(max_retries=2, backoff_s=0.0),
        on_retry=on_retry, on_demote=on_demote, retry_on=retry_on)
    if retried:
        with pytest.warns(RuntimeWarning, match="demoting backend fused"):
            sup.call(attempt, backend="fused", demote=lambda: fallback)
        assert counts == {"attempts": 3, "retries": 2, "demoted": 1,
                          "fallback": 1}
    else:
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            sup.call(attempt, backend="fused", demote=lambda: fallback)
        assert counts == {"attempts": 1, "retries": 0, "demoted": 0,
                          "fallback": 0}


def test_engine_on_the_cpu_keeps_the_reference_retry_policy():
    _, port = _engines(num_slots=1)
    assert port._supervisor.retry_on == (Exception,)


# ----------------------------------------------------- drain hardening
def test_drain_timeout_raises_with_stall_snapshot():
    f = [dict(tick=1, kind="stall", ticks=10**9)]
    ref_inj, port_inj = _injectors(faults_=f)
    ref, port = _engines(num_slots=2, ref_kw={"injector": ref_inj},
                         port_kw={"injector": port_inj})
    snaps = []
    for eng, mod in ((ref, ref_engine), (port, engine)):
        eng.submit(mod.StreamRequest(spikes=_train(0)))
        with pytest.raises(mod.EngineStallError) as ei:
            eng.drain(timeout_s=0.3)
        snaps.append(ei.value.snapshot)
    r_snap, p_snap = snaps
    assert set(p_snap) == set(r_snap)
    stuck = [d for d in p_snap["slots"] if d["rid"] is not None]
    assert len(stuck) == 1
    assert stuck[0]["done"] < stuck[0]["total"]
    r_stuck = [d for d in r_snap["slots"] if d["rid"] is not None]
    assert stuck == r_stuck


def test_drain_without_timeout_unchanged():
    _, port = _engines(num_slots=2)
    port.submit(engine.StreamRequest(spikes=_train(0)))
    assert len(port.drain()) == 1


# ------------------------------------------------ load shedding e2e
def test_backpressure_sheds_and_parks_end_to_end():
    ref, port = _engines(
        num_slots=1,
        ref_kw={"admission": ref_faults.AdmissionPolicy(max_queue_depth=2)},
        port_kw={"admission": faults.AdmissionPolicy(max_queue_depth=2)})
    out = []
    for eng, mod in ((ref, ref_engine), (port, engine)):
        rids = [eng.submit(mod.StreamRequest(
            spikes=_train(i), priority=1 if i == 5 else 0)) for i in range(6)]
        out.append((rids, eng.drain()))
    (r_rids, r_res), (p_rids, p_res) = out
    assert p_rids == r_rids
    _assert_same(r_res, p_res)
    by_rid = _by_rid(p_res)
    assert [by_rid[r].disposition for r in p_rids] == [
        "ok", "ok", "shed", "shed", "shed", "ok"]
    assert by_rid[p_rids[5]].parked
    for r in p_rids[2:5]:
        assert by_rid[r].fault == "queue_full"
        assert by_rid[r].prediction == -1
    assert port.shed_rate() == ref.shed_rate() == pytest.approx(0.5)
    assert _counter(port, "engine.requests.parked") == 1
    assert port.health()["diagnosis"]["verdict"] in ("overloaded", "nominal")


def test_feasibility_sheds_provably_unmeetable_deadline():
    ref, port = _engines(
        num_slots=1,
        ref_kw={"admission": ref_faults.AdmissionPolicy()},
        port_kw={"admission": faults.AdmissionPolicy()})
    out = []
    for eng, mod in ((ref, ref_engine), (port, engine)):
        eng.run([mod.StreamRequest(spikes=_train(0))])  # a measured rate
        assert eng.measured_ticks_per_s() > 0
        hopeless = eng.submit(mod.StreamRequest(spikes=_train(1),
                                                deadline_s=0.0))
        fine = eng.submit(mod.StreamRequest(spikes=_train(2)))
        res = _by_rid(eng.drain())
        assert res[hopeless].disposition == "shed"
        assert res[hopeless].fault == "deadline_unmeetable"
        assert res[fine].disposition == "ok"
        assert eng.deadline_misses == 0
        out.append(list(res.values()))
    _assert_same(*out)


def test_shed_rate_slo_opt_in():
    from repro_torch.obs import default_slos, shed_rate_slo

    _, port = _engines(
        TINY, num_slots=1,
        port_kw={"admission": faults.AdmissionPolicy(max_queue_depth=1),
                 "slos": default_slos() + (shed_rate_slo(objective=0.99),)})
    for i in range(4):
        port.submit(engine.StreamRequest(spikes=_train(i, cfg=TINY)))
    port.drain()
    entries = {s["name"]: s for s in port.health()["slos"]}
    assert set(entries) == {"deadline_misses", "latency_p99", "shed_rate"}
    err = entries["shed_rate"]["observed_error_rate"]
    assert err is not None and 0.0 < err <= 1.0
    assert port.shed_rate() == pytest.approx(0.75)


def test_no_admission_policy_serves_hopeless_deadlines():
    _, port = _engines(num_slots=1)
    port.run([engine.StreamRequest(spikes=_train(0))])
    res = port.run([engine.StreamRequest(spikes=_train(1), deadline_s=0.0)])[0]
    assert res.disposition == "ok"
    assert res.deadline_missed
    assert port.shed_rate() == 0.0


# --------------------------------------------------- chaos invariants
def _chaos_pair(cfg, schedule_kw, n_req, *, backend="torch", num_slots=2,
                seed0=100):
    """The same requests through both engines, each with its own injector
    over ``FaultSchedule.generate(**schedule_kw)`` (None: no injector)."""
    ref_inj = port_inj = None
    if schedule_kw is not None:
        ref_inj, port_inj = _injectors(schedule_kw)
    ref, port = _engines(
        cfg, backend=backend, num_slots=num_slots,
        ref_kw={"injector": ref_inj, "retry": ref_faults.RetryPolicy(
            max_retries=8, backoff_s=0.0)},
        port_kw={"injector": port_inj, "retry": faults.RetryPolicy(
            max_retries=8, backoff_s=0.0)})
    trains = [_train(seed0 + i, cfg=cfg) for i in range(n_req)]
    results = []
    for eng, mod in ((ref, ref_engine), (port, engine)):
        for r in _requests(mod, trains):
            eng.submit(r)
        results.append(eng.drain(timeout_s=120.0))
    return (ref, ref_inj, results[0]), (port, port_inj, results[1])


def _schedule(seed, n=6, ticks=30, num_slots=2,
              kinds=("nan_membrane", "corrupt_ring", "chunk_exception",
                     "stall")):
    return dict(seed=seed, n_faults=n, ticks=ticks, num_slots=num_slots,
                kinds=kinds, num_layers=2)


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_empty_schedule_bitmatches_oracle(backend):
    empty = dict(seed=0, n_faults=0, ticks=1, num_slots=2)
    (ref, _, r_res), (port, _, p_res) = _chaos_pair(TINY, empty, 4,
                                                   backend=backend)
    (_, _, _), (oracle_eng, _, oracle) = _chaos_pair(TINY, None, 4,
                                                     backend=backend)
    assert [r.disposition for r in p_res] == ["ok"] * 4
    _assert_same(oracle, p_res)
    _assert_same(r_res, p_res)
    for name in ("engine.requests.shed", "engine.requests.quarantined",
                 "engine.faults.chunk_retries",
                 "engine.faults.backend_demoted", "engine.faults.injected"):
        assert _counter(port, name) == 0, name


@settings(max_examples=4, deadline=None)
@given(seed=st.integers(min_value=0, max_value=10**6))
def test_chaos_never_crashes_property(seed):
    for backend in ("torch", "fused"):
        (ref, _, r_res), (port, _, p_res) = _chaos_pair(
            TINY, _schedule(seed), 8, backend=backend)
        assert sorted(r.request_id for r in p_res) == list(range(8))
        assert all(r.disposition in ("ok", "quarantined") for r in p_res)
        _assert_same(r_res, p_res)
        assert port.idle()


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_chaos_seeded_examples(backend, seed):
    (ref, r_inj, r_res), (port, p_inj, p_res) = _chaos_pair(
        TINY, _schedule(seed), 8, backend=backend)
    assert sorted(r.request_id for r in p_res) == list(range(8))
    assert all(r.disposition in ("ok", "quarantined") for r in p_res)
    for r in p_res:
        if r.disposition == "quarantined":
            assert r.fault is not None
    assert p_inj.applied == r_inj.applied
    assert p_inj.raised == r_inj.raised
    assert port.fault_events == ref.fault_events
    _assert_same(r_res, p_res)
    assert port.idle()


@pytest.mark.parametrize("seed", [7, 8])
def test_chaos_nan_and_ring_schedule_equals_the_reference(seed):
    """A seeded schedule of state and ring faults only, at REF_CFG and 3
    slots: the port quarantines exactly the requests the reference does,
    and every other request equals the reference's and the fault-free
    run's."""
    sched = _schedule(seed, n=6, ticks=18, num_slots=3,
                      kinds=("nan_membrane", "corrupt_ring"))
    (ref, r_inj, r_res), (port, p_inj, p_res) = _chaos_pair(
        REF_CFG, sched, 18, num_slots=3)
    _assert_same(r_res, p_res)
    assert p_inj.applied == r_inj.applied and len(p_inj.applied) == 6
    faulted = {rec["rid"] for rec in p_inj.applied}
    assert {r.request_id for r in p_res
            if r.disposition == "quarantined"} == faulted
    (_, _, _), (_, _, oracle) = _chaos_pair(REF_CFG, None, 18, num_slots=3)
    clean = _by_rid(oracle)
    _assert_same([clean[r.request_id] for r in p_res
                  if r.request_id not in faulted],
                 [r for r in p_res if r.request_id not in faulted])
    _assert_memsums(ref, port)


def test_chaos_acceptance_200_requests_20_faults():
    """The reference's acceptance run through both engines: >= 20 seeded
    faults (NaN membranes, corrupt rings, transient chunk exceptions)
    over 200 requests on 4 slots.  The port equals the reference request
    by request, crashes never, quarantines exactly the faulted requests,
    serves every other one as the fault-free run does, and recovers
    within a few ticks of each injection."""
    n_req = 200
    sched = dict(seed=7, n_faults=24, ticks=180, num_slots=4, num_layers=2,
                 kinds=("nan_membrane", "corrupt_ring", "chunk_exception"))
    (ref, r_inj, r_res), (port, inj, results) = _chaos_pair(
        REF_CFG, sched, n_req, num_slots=4)
    assert len(inj.schedule) >= 20
    _assert_same(r_res, results)
    assert inj.applied == r_inj.applied
    assert port.fault_events == ref.fault_events
    assert sorted(r.request_id for r in results) == list(range(n_req))
    assert port.idle()
    faulted = {rec["rid"] for rec in inj.applied
               if rec["kind"] in ("nan_membrane", "corrupt_ring")}
    assert len(faulted) >= 10
    quarantined = {r.request_id for r in results
                   if r.disposition == "quarantined"}
    assert quarantined == faulted
    assert _counter(port, "engine.requests.quarantined") == len(quarantined)
    assert _counter(port, "engine.faults.chunk_retries") == inj.raised > 0
    (_, _, _), (_, _, oracle) = _chaos_pair(REF_CFG, None, n_req,
                                            num_slots=4)
    clean = _by_rid(oracle)
    _assert_same([clean[r.request_id] for r in results
                  if r.request_id not in faulted],
                 [r for r in results if r.request_id not in faulted])
    applied = {rec["rid"]: rec["tick"] for rec in inj.applied
               if rec["kind"] in ("nan_membrane", "corrupt_ring")}
    for ev in port.fault_events:
        assert 1 <= ev["tick"] - applied[ev["rid"]] <= 6, ev


def test_fault_checks_off_matches_checks_on_clean_traffic():
    trains = [_train(i) for i in range(4)]
    ref, on = _engines(num_slots=2, chunk_steps=7)
    _, off = _engines(num_slots=2, chunk_steps=7,
                      port_kw={"fault_checks": False})
    r_res = ref.run(_requests(ref_engine, trains))
    _assert_same(r_res, on.run(_requests(engine, trains)))
    _assert_same(r_res, off.run(_requests(engine, trains)))
    assert all(r.disposition == "ok" for r in r_res)


def test_fault_checks_off_nan_poisons_silently():
    """The negative control: with ``fault_checks=False`` an injected NaN
    in the output layer is not caught; the request is served ``ok`` while
    its folded membrane sum is NaN, in the port as in the reference."""
    f = [dict(tick=1, kind="nan_membrane", slot=0, layer=1)]
    ref_inj, port_inj = _injectors(faults_=f)
    ref, port = _engines(
        num_slots=1, fault_checks=False, ref_kw={"injector": ref_inj},
        port_kw={"injector": port_inj})
    r = ref.run(_requests(ref_engine, [_train(0)]))
    p = port.run(_requests(engine, [_train(0)]))
    _assert_same(r, p)
    assert p[0].disposition == "ok"
    assert _counter(port, "engine.requests.quarantined") == 0
    assert not np.all(np.isfinite(port._slot_memsum[0]))
    np.testing.assert_array_equal(np.isfinite(port._slot_memsum),
                                  np.isfinite(ref._slot_memsum))


def test_fault_checks_flag_is_fixed_at_construction():
    """The flag decides what the chunk computes, so a graph is captured
    with the checks or without them; the staged overflow bit follows it."""
    _, off = _engines(num_slots=1, capacities=(8, 24),
                      port_kw={"fault_checks": False})
    dense = np.ones((REF_CFG.num_steps, REF_CFG.layer_sizes[0]), np.float32)
    res = off.run(_requests(engine, [dense]))[0]
    assert res.disposition == "ok"  # truncated silently, not flagged
    assert off.fault_events == []
