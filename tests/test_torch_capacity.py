"""Port parity: capacity autotuning (``events.capacity``) and the serving
engine under a tuned plan, against the JAX reference on the CPU.

The same spike trains, made with numpy from a seed, go to both packages.
Counts and plans must be equal field for field, the truncation report
equal in its integer-valued entries with the membrane drift within 1e-5,
and the engines equal request by request (REF_CFG 64-24-2, T = 20, 3
slots, Tc = 5), an overflowing request quarantined in both."""

import dataclasses
import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

from _torch_parity import np_tree, params_pair, port_cfg, spikes, t
from repro.core import snn as ref_snn
from repro.events import capacity as ref_cap
from repro.serving import snn_engine as ref_engine
from repro_torch.core import snn as port_snn
from repro_torch.events import capacity as cap
from repro_torch.serving import snn_engine as engine

REF_CFG = ref_snn.SNNConfig(layer_sizes=(64, 24, 2), num_steps=20)
RNG = np.random.default_rng(23)
_PARAMS = {}


def _params(cfg=REF_CFG):
    """(reference, port) params with equal values; hidden and output
    thresholds lowered so that the hidden counts are not all zero."""
    if cfg.layer_sizes not in _PARAMS:
        tree = np_tree(params_pair(cfg, seed=2)[0])
        for lp in tree.values():
            lp["threshold"] = np.full_like(lp["threshold"], 0.2)
        _PARAMS[cfg.layer_sizes] = (
            {n: {k: jnp.asarray(v) for k, v in lp.items()}
             for n, lp in tree.items()},
            port_snn.params_from_numpy(tree, "cpu"),
        )
    return _PARAMS[cfg.layer_sizes]


def _sample(T, B, rate, cfg=REF_CFG):
    return spikes(RNG, (T, B, cfg.layer_sizes[0]), rate)


@pytest.mark.parametrize("backend", ["torch", "fused"])
@pytest.mark.parametrize("rate", [0.0, 0.25, 0.8])
def test_measure_step_counts_equal_reference(backend, rate):
    ref_p, port_p = _params()
    x = _sample(10, 4, rate)
    got = cap.measure_step_counts(port_p, port_cfg(REF_CFG), t(x),
                                  backend=backend)
    ref = ref_cap.measure_step_counts(ref_p, REF_CFG, x)
    assert got.shape == ref.shape == (2, 40)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, np.round(got))  # integer counts


PLAN_CASES = [
    # (rate, autotune keywords): the cases of tests/test_snn_chunk.py
    (0.25, dict(percentile=100.0, safety=1.2, align=8)),
    (0.2, dict(percentile=100.0, safety=1.5, align=8)),
    (0.8, dict(percentile=50.0, safety=1.0, align=8)),
    (0.3, {}),  # the defaults: percentile 100, safety 1.25, align 128
    (0.3, dict(percentile=90.0, safety=1.1, align=16, tune_hidden=True)),
    (0.05, dict(percentile=75.0, safety=2.0, align=1)),
]


@pytest.mark.parametrize("rate,kw", PLAN_CASES)
def test_autotune_plan_equals_reference(rate, kw):
    ref_p, port_p = _params()
    x = _sample(10, 4, rate)
    got = cap.autotune(port_p, port_cfg(REF_CFG), t(x), **kw)
    ref = ref_cap.autotune(ref_p, REF_CFG, x, **kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.shrink == ref.shrink
    assert got.as_dict() == ref.as_dict()
    for c, f in zip(got.capacities, got.fan_in):
        assert 1 <= c <= f


def test_autotune_from_given_counts_and_on_fused_counts():
    ref_p, port_p = _params()
    x = _sample(8, 3, 0.3)
    counts = ref_cap.measure_step_counts(ref_p, REF_CFG, x)
    got = cap.autotune(port_p, port_cfg(REF_CFG), None, counts=counts)
    fused = cap.measure_step_counts(port_p, port_cfg(REF_CFG), t(x),
                                    backend="fused")
    assert got == cap.autotune(port_p, port_cfg(REF_CFG), None, counts=fused)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        ref_cap.autotune(ref_p, REF_CFG, x, counts=counts))


@pytest.mark.parametrize("rate,kw,backend", [
    (rate, kw, backend) for rate, kw in PLAN_CASES
    for backend in ("torch", "fused")
    # the fused chunk refuses a truncating hidden plan (tested below)
    if not (backend == "fused" and kw.get("tune_hidden"))
])
def test_truncation_report_equals_reference(rate, kw, backend):
    ref_p, port_p = _params()
    x = _sample(10, 4, rate)
    ref_plan = ref_cap.autotune(ref_p, REF_CFG, x, **kw)
    plan = cap.autotune(port_p, port_cfg(REF_CFG), t(x), **kw)
    y = _sample(10, 5, rate)  # held-out
    got = cap.truncation_report(port_p, port_cfg(REF_CFG), t(y), plan,
                                backend=backend)
    ref = ref_cap.truncation_report(ref_p, REF_CFG, y, ref_plan)
    assert set(got) == set(ref)
    drift = got.pop("out_mem_max_abs_diff")
    assert abs(drift - ref.pop("out_mem_max_abs_diff")) <= 1e-5
    assert got == ref


def test_fused_refuses_truncating_hidden_capacity():
    ref_p, port_p = _params()
    x = _sample(8, 3, 0.5)
    kw = dict(percentile=50.0, safety=1.0, align=1, tune_hidden=True)
    plan = cap.autotune(port_p, port_cfg(REF_CFG), t(x), **kw)
    assert plan.capacities[1] < REF_CFG.layer_sizes[1]
    with pytest.raises(ValueError, match="cannot truncate hidden"):
        cap.truncation_report(port_p, port_cfg(REF_CFG), t(x), plan,
                              backend="fused")
    with pytest.raises(ValueError, match="cannot truncate hidden"):
        ref_cap.truncation_report(
            ref_p, REF_CFG, x, ref_cap.autotune(ref_p, REF_CFG, x, **kw),
            backend="fused")
    # the plain backend truncates hidden layers as the reference's jnp does
    got = cap.truncation_report(port_p, port_cfg(REF_CFG), t(x), plan)
    assert got["events_dropped_frac"] > 0.0


# ------------------------------------------------ the engine, tuned plan
BACKENDS = {"torch": "jnp", "fused": "fused"}  # port -> reference


def _tuned_plan():
    ref_p, _ = _params()
    return ref_cap.autotune(ref_p, REF_CFG, _sample(20, 6, 0.3), align=8)


def _engines(capacities, backend="torch", num_slots=3):
    ref_p, port_p = _params()
    kw = dict(num_slots=num_slots, chunk_steps=5, capacities=capacities)
    return (
        ref_engine.SNNStreamEngine(ref_p, REF_CFG, backend=BACKENDS[backend],
                                   **kw),
        engine.SNNStreamEngine(port_p, port_cfg(REF_CFG), backend=backend,
                               device="cpu", **kw),
    )


def _trains():
    """Six trains at the sample's rate, one so busy that its steps
    overflow the tuned capacity, and one shorter window."""
    trains = [spikes(RNG, (20, 64), 0.3) for _ in range(6)]
    trains.insert(2, spikes(RNG, (20, 64), 0.95))
    trains.append(spikes(RNG, (12, 64), 0.3))
    return trains


def _assert_same(ref_results, port_results):
    assert len(ref_results) == len(port_results)
    for a, b in zip(sorted(ref_results, key=lambda r: r.request_id),
                    sorted(port_results, key=lambda r: r.request_id)):
        assert (b.request_id, b.disposition, b.fault, b.prediction,
                b.steps) == (a.request_id, a.disposition, a.fault,
                             a.prediction, a.steps)
        np.testing.assert_array_equal(b.spike_counts, a.spike_counts)
        np.testing.assert_array_equal(b.events_per_layer, a.events_per_layer)
        assert b.energy_pj == a.energy_pj
        assert b.spike_rate == pytest.approx(a.spike_rate, rel=1e-9, abs=0.0)


@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_tuned_engine_equals_reference_request_by_request(backend):
    plan = _tuned_plan()
    assert plan.capacities[0] < REF_CFG.layer_sizes[0]
    ref, port = _engines(plan.capacities, backend)
    assert port.C == ref.C == plan.capacities[0]
    trains = _trains()
    reqs = [dict(spikes=x, num_steps=len(x)) for x in trains]
    r = ref.run([ref_engine.StreamRequest(**k) for k in reqs])
    p = port.run([engine.StreamRequest(**k) for k in reqs])
    _assert_same(r, p)
    quarantined = [x for x in p if x.disposition == "quarantined"]
    assert [x.request_id for x in quarantined] == [2]
    assert quarantined[0].fault == "capacity_overflow"
    assert all(x.disposition == "ok" for x in p if x.request_id != 2)
    assert [f["fault"] for f in port.fault_events] == ["capacity_overflow"]


def test_tuned_engine_equals_untuned_where_nothing_overflows():
    plan = _tuned_plan()
    trains = [x for x in _trains() if (x != 0).sum(-1).max() <= plan.capacities[0]]
    tuned = _engines(plan.capacities)[1]
    full = _engines(None)[1]
    assert full.C == 64 and tuned.C == plan.capacities[0]
    a = tuned.run([engine.StreamRequest(spikes=x, num_steps=len(x))
                   for x in trains])
    b = full.run([engine.StreamRequest(spikes=x, num_steps=len(x))
                  for x in trains])
    _assert_same(b, a)
    assert tuned._ring["addrs"].shape[-1] == plan.capacities[0]


def test_snapshot_carries_the_tuned_capacity_and_refuses_another(tmp_path):
    plan = _tuned_plan()
    ref, port = _engines(plan.capacities)
    x = _trains()[0]
    ref.submit(ref_engine.StreamRequest(spikes=x))
    port.submit(engine.StreamRequest(spikes=x))
    ref.poll()
    port.poll()
    port_path = port.snapshot(str(tmp_path / "port"))
    ref_path = ref.snapshot(str(tmp_path / "ref"))
    for path in (port_path, ref_path):
        with open(os.path.join(path, "manifest.json")) as f:
            geometry = json.load(f)["geometry"]
        assert geometry["event_capacity"] == plan.capacities[0]
        # an engine of another capacity refuses it as a geometry mismatch
        for other in (_engines(None)[1], _engines((48, 24))[1]):
            with pytest.raises(ValueError, match="geometry mismatch"):
                other.restore(path)
        same = _engines(plan.capacities)[1]
        same.restore(path)
        assert same.C == plan.capacities[0]
    with pytest.raises(ValueError, match="geometry mismatch"):
        _engines(None)[0].restore(port_path)


def test_ring_growth_keeps_the_tuned_capacity():
    plan = _tuned_plan()
    ref, port = _engines(plan.capacities, num_slots=2)
    long = spikes(RNG, (33, 64), 0.3)  # longer than the ring: it grows
    r = ref.run([ref_engine.StreamRequest(spikes=long, num_steps=33)])
    p = port.run([engine.StreamRequest(spikes=long, num_steps=33)])
    _assert_same(r, p)
    assert port._ring_steps == 33 and port.C == plan.capacities[0]
    assert {k: tuple(v.shape) for k, v in port._ring.items()} == {
        "addrs": (2, 38, plan.capacities[0]),
        "values": (2, 38, plan.capacities[0]),
        "counts": (2, 38),
    }
