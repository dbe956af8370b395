"""The serving cell at a tiny size on the CPU: a sound run is correct, its
rates and tail cover the whole window, and each fault the cell can have,
planted under the timed path, turns ``correct`` false."""

import numpy as np
import pytest

import pb_tiny

CELL = "snn-dvs-closed-s128-t100"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return pb_tiny.make_root(tmp_path_factory.mktemp("pb_serve"))


def test_sound_run_is_correct_and_reports_its_metrics(root, capsys):
    import json

    from portbench import harness

    res, checks = pb_tiny.run(root, CELL)
    assert res["correct"], checks
    assert res["failed"] == 0 and res["attempted"] > 0
    m = res["metrics"]
    assert set(m) == {"snn_req_per_s", "snn_latency_p95_ms", "setup_s"}
    assert m["snn_req_per_s"]["value"] > 0
    assert res["device"]["platform"] == "cpu"
    harness.emit(res, checks)
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["correct"]
    assert err.strip().splitlines()[-1].startswith("check ")


def test_traced_run_reports_host_layers_and_no_device_share(root):
    res, _ = pb_tiny.run(root, CELL, trace=True)
    assert res["correct"]
    got = set(res["metrics"])
    assert {"snn.tick_host_ms", "snn.admit_ms",
            "snn.queue_wait_p95_ms"} <= got
    # a CPU run has no device time: no roofline, mfu or idle share
    assert not got & {"snn_chunk_roofline", "snn.mfu_pct",
                      "snn.device_idle_pct"}
    assert "breakdown" in res and res["device"]["busy_s"] == 0.0


def test_rate_and_tail_cover_the_whole_window(root, monkeypatch):
    """Stalls inside the window's polls are in every latency behind them
    and in the window's time: each answer waits through at least two
    stalled polls, so the tail holds 40 ms and 4 slots answer at most 4
    windows a 40 ms."""
    import time

    from repro_torch.serving import snn_engine

    poll = snn_engine.SNNStreamEngine.poll

    def stalled(self):
        time.sleep(0.02)
        return poll(self)

    monkeypatch.setattr(snn_engine.SNNStreamEngine, "poll", stalled)
    slow, _ = pb_tiny.run(root, CELL, seconds=0.6)
    assert slow["metrics"]["snn_latency_p95_ms"]["value"] >= 40.0
    assert slow["metrics"]["snn_req_per_s"]["value"] <= 4 / 0.04


def _state_unchanged(monkeypatch):
    from repro_torch.events import runtime

    real = runtime.run_chunk_events

    def chunk(params, states, *a, **k):
        _, mem, spk, ev = real(params, states, *a, **k)
        return list(states), mem, spk, ev

    monkeypatch.setattr(runtime, "run_chunk_events", chunk)


def _half_the_slots(monkeypatch):
    from repro_torch.events import runtime

    real = runtime.run_chunk_events

    def chunk(params, states, addrs, values, *a, **k):
        values = values.clone()
        values[values.shape[0] // 2:] = 0  # slot-major: slots first
        return real(params, states, addrs, values, *a, **k)

    monkeypatch.setattr(runtime, "run_chunk_events", chunk)


def _answer_altered(monkeypatch):
    from repro_torch.serving import snn_engine

    real = snn_engine.SNNStreamEngine._finalize

    def finalize(self, s):
        r = real(self, s)
        r.spike_counts = np.asarray(r.spike_counts) + 1.0
        return r

    monkeypatch.setattr(snn_engine.SNNStreamEngine, "_finalize", finalize)


@pytest.mark.parametrize("plant", [_state_unchanged, _half_the_slots,
                                   _answer_altered],
                         ids=["state_unchanged", "half_the_slots",
                              "answer_altered"])
def test_a_fault_under_the_timed_path_is_not_correct(root, monkeypatch,
                                                      plant):
    plant(monkeypatch)
    res, checks = pb_tiny.run(root, CELL)
    assert not res["correct"], checks


@pytest.mark.parametrize("fault", ["readout_no_leak", "counts_off_by_one"])
def test_a_readout_fault_alone_is_not_correct(root, fault):
    """Faults of the readout alone (the 16 -> 2 layer's leak dropped; an
    output count altered where the answer is produced), planted as the
    card's readings plant them, turn ``correct`` false by the readout's
    own numbers."""
    from portbench import registry

    undo = registry.driver("snn_serve", root).FAULTS[fault]()
    try:
        res, checks = pb_tiny.run(root, CELL)
    finally:
        undo()
    assert not res["correct"], checks
    assert not (checks["output_spike_gap"]["ok"]
                and checks["prediction_gap"]["ok"]), checks
