"""Port parity: the streaming engine on the CPU against the reference
engine, per request; image requests; device selection; launch counts."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from _torch_parity import params_pair, port_cfg, spikes
from repro.core import snn as ref_snn
from repro.serving import snn_engine as ref_engine
from repro_torch.kernels import snn_chunk as chunk_mod
from repro_torch.launch import serve
from repro_torch.serving import snn_engine as engine

REF_CFG = ref_snn.SNNConfig(layer_sizes=(64, 24, 2), num_steps=20)
STEPS = [20, 13, 7, 20, 17, 5, 11]  # ragged windows, more requests than slots


def _trains(seed=0):
    rng = np.random.default_rng(seed)
    return [spikes(rng, (T, 64), 0.3) for T in STEPS]


@pytest.fixture(scope="module")
def reference_results():
    ref_p, _ = params_pair(REF_CFG, seed=0)
    eng = ref_engine.SNNStreamEngine(
        ref_p, REF_CFG, num_slots=3, chunk_steps=5, backend="jnp"
    )
    reqs = [
        ref_engine.StreamRequest(spikes=x, num_steps=x.shape[0])
        for x in _trains()
    ]
    return eng.run(reqs)


@pytest.mark.parametrize("backend", ["torch", "fused"])
@pytest.mark.parametrize("pipeline_depth", [0, 1])
def test_engine_matches_reference_engine(reference_results, backend,
                                         pipeline_depth):
    _, port_p = params_pair(REF_CFG, seed=0)
    eng = engine.SNNStreamEngine(
        port_p, port_cfg(REF_CFG), num_slots=3, chunk_steps=5,
        backend=backend, pipeline_depth=pipeline_depth, device="cpu",
    )
    reqs = [
        engine.StreamRequest(spikes=x, num_steps=x.shape[0]) for x in _trains()
    ]
    results = eng.run(reqs)
    assert [r.request_id for r in results] == list(range(len(STEPS)))
    for got, ref in zip(results, reference_results):
        assert got.disposition == ref.disposition == "ok"
        assert got.steps == ref.steps
        assert got.prediction == ref.prediction
        np.testing.assert_array_equal(got.spike_counts, ref.spike_counts)
        np.testing.assert_array_equal(got.events_per_layer, ref.events_per_layer)
        assert got.spike_rate == ref.spike_rate
        np.testing.assert_allclose(got.energy_pj, ref.energy_pj, rtol=1e-9)
    assert eng.idle() and eng.completed == len(STEPS)
    assert eng.total_events == pytest.approx(
        sum(r.events_per_layer.sum() for r in results)
    )
    assert eng.events_per_sec() > 0 and eng.deadline_miss_rate() == 0.0


def test_image_request_served_and_counts_no_launch_on_cpu():
    _, port_p = params_pair(REF_CFG, seed=0)
    eng = engine.SNNStreamEngine(
        port_p, port_cfg(REF_CFG), num_slots=2, chunk_steps=5,
        backend="fused", device="cpu",
    )
    chunk_mod.snn_chunk.launches = 0
    img = np.random.default_rng(1).random(64).astype(np.float32)
    res = eng.run([
        engine.StreamRequest(image=img),
        engine.StreamRequest(image=img, num_steps=9, deadline_s=60.0),
    ])
    assert chunk_mod.snn_chunk.launches == 0  # plain version on the CPU
    assert eng.dispatched_ticks == 4
    for r, T in zip(res, (20, 9)):
        assert r.disposition == "ok" and r.steps == T
        assert r.prediction in (0, 1)
        assert 0 < r.events_per_layer[0] <= T * 64
        assert np.isfinite(r.energy_pj) and r.energy_pj > 0
        assert not r.deadline_missed


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, port_p = params_pair(REF_CFG, seed=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.SNNStreamEngine(port_p, port_cfg(REF_CFG))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--snn", "--requests", "1"])
    assert engine.resolve_device("cpu").type == "cpu"


def test_capacity_overflow_is_quarantined_and_others_served():
    _, port_p = params_pair(REF_CFG, seed=0)
    trains = _trains()[:3]
    eng = engine.SNNStreamEngine(
        port_p, port_cfg(REF_CFG), num_slots=2, chunk_steps=5,
        capacities=(40, 24), device="cpu",
    )
    dense = np.ones((20, 64), np.float32)  # 64 events a step > C = 40
    res = eng.run(
        [engine.StreamRequest(spikes=x, num_steps=x.shape[0]) for x in trains]
        + [engine.StreamRequest(spikes=dense)]
    )
    assert [r.disposition for r in res] == ["ok", "ok", "ok", "quarantined"]
    assert res[3].fault == "capacity_overflow"
    assert eng.fault_events[0]["rid"] == 3


def test_edf_admission_order_and_submit_validation():
    _, port_p = params_pair(REF_CFG, seed=0)
    eng = engine.SNNStreamEngine(
        port_p, port_cfg(REF_CFG), num_slots=1, chunk_steps=20, device="cpu"
    )
    x = _trains()[0]
    base = engine.StreamRequest(spikes=x)
    ids = [
        eng.submit(base),
        eng.submit(dataclasses.replace(base, deadline_s=50.0)),
        eng.submit(dataclasses.replace(base, deadline_s=10.0)),
        eng.submit(dataclasses.replace(base, priority=1)),
    ]
    order = [r.request_id for r in eng.drain(timeout_s=60.0)]
    assert order == [ids[3], ids[2], ids[1], ids[0]]
    late = [eng.submit(base), eng.submit(base)]  # one slot: two polls
    with pytest.raises(engine.EngineStallError) as stall:
        eng.drain(timeout_s=0.0)  # expires after the first poll
    assert [r.request_id for r in stall.value.results] == late[:1]
    assert [r.request_id for r in eng.drain(timeout_s=60.0)] == late[1:]
    with pytest.raises(ValueError, match="shape"):
        eng.submit(engine.StreamRequest(spikes=x[:5]))
    with pytest.raises(ValueError, match="integer-valued"):
        eng.submit(engine.StreamRequest(spikes=x * 0.5))
    with pytest.raises(ValueError, match="num_steps"):
        eng.submit(engine.StreamRequest(spikes=x, num_steps=0))
    with pytest.raises(ValueError, match="NaN"):
        eng.submit(engine.StreamRequest(image=np.full(64, np.nan)))


def test_longer_window_grows_the_ring():
    _, port_p = params_pair(REF_CFG, seed=0)
    eng = engine.SNNStreamEngine(
        port_p, port_cfg(REF_CFG), num_slots=2, chunk_steps=5, device="cpu"
    )
    rng = np.random.default_rng(3)
    long = spikes(rng, (33, 64), 0.3)
    res = eng.run([
        engine.StreamRequest(spikes=_trains()[0]),
        engine.StreamRequest(spikes=long, num_steps=33),
    ])
    assert [r.steps for r in res] == [20, 33]
    assert res[1].events_per_layer[0] == long.sum()


def test_serve_cli_on_cpu(capsys):
    serve.main(["--snn", "--requests", "3", "--batch", "2", "--image-hw", "8",
                "--hidden", "16", "--num-steps", "6", "--chunk-steps", "4",
                "--device", "cpu", "--snn-backend", "fused"])
    out = capsys.readouterr().out
    assert "snn[64->16->2, T=6, rate-coded]: served 3 reqs" in out
    assert jax is not None  # the reference package stays importable beside
