"""Port parity: DVS serving (``launch/serve.py --dvs --polarity``) and the
launcher's SLOs.  The DVS planes of one seeded reference stream go to
both packages' engines, which must agree request by request; the
launcher runs at a tiny size on the CPU."""

import jax
import numpy as np
import pytest

from _torch_parity import np_tree, params_pair, port_cfg, t
from repro import obs as ref_obs
from repro.core import snn as ref_snn
from repro.events import aer as ref_aer
from repro.serving import snn_engine as ref_engine
from repro_torch.core import snn as port_snn
from repro_torch.events import aer
from repro_torch.launch import serve
from repro_torch.serving import snn_engine as engine

HW, T = 8, 10
TINY = ["--snn", "--device", "cpu", "--requests", "3", "--batch", "2",
        "--image-hw", str(HW), "--hidden", "16", "--num-steps", "6",
        "--chunk-steps", "4"]


@pytest.mark.parametrize("polarity,input_size", [
    ("signed", HW * HW), ("two_channel", 2 * HW * HW), ("on_only", HW * HW)])
def test_serve_dvs_cli(capsys, polarity, input_size):
    serve.main(TINY + ["--dvs", "--polarity", polarity])
    out = capsys.readouterr().out
    assert (f"snn[{input_size}->16->2, T=6, dvs-events/{polarity}]: "
            f"served 3 reqs") in out
    assert "(ok 3 | shed 0 | quarantined 0)" in out


def test_serve_rate_coded_cli_names_its_source(capsys):
    serve.main(TINY)
    assert f"snn[{HW * HW}->16->2, T=6, rate-coded]: served 3" in (
        capsys.readouterr().out)


def _dvs_planes(polarity, n=5):
    """(reference planes, port planes) of one seeded reference stream."""
    stream, _ = ref_aer.dvs_collision_batch(
        jax.random.PRNGKey(7), n, image_hw=HW, num_steps=T,
        capacity=8 * HW * HW)
    ref = np.asarray(ref_aer.input_planes(stream, T, HW * HW,
                                          polarity_mode=polarity))
    port = aer.input_planes(aer.EventStream(*(t(np.asarray(x))
                                              for x in stream)),
                            T, HW * HW, polarity_mode=polarity)
    return ref, port.numpy()


@pytest.mark.parametrize("polarity", ["signed", "two_channel"])
@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_dvs_planes_served_equal_by_both_engines(polarity, backend):
    ref_planes, planes = _dvs_planes(polarity)
    np.testing.assert_array_equal(planes, ref_planes)
    K = aer.input_size_for(HW * HW, polarity)
    assert planes.shape == (T, 5, K)
    cfg = ref_snn.SNNConfig(layer_sizes=(K, 16, 2), num_steps=T)
    tree = np_tree(params_pair(cfg, seed=1)[0])
    for lp in tree.values():  # low enough that the output layer spikes
        lp["threshold"] = np.full_like(lp["threshold"], 0.05)
    ref_p = {n: {k: jax.numpy.asarray(v) for k, v in lp.items()}
             for n, lp in tree.items()}
    kw = dict(num_slots=3, chunk_steps=5)
    ref = ref_engine.SNNStreamEngine(
        ref_p, cfg, backend={"torch": "jnp", "fused": "fused"}[backend], **kw)
    port = engine.SNNStreamEngine(
        port_snn.params_from_numpy(tree, "cpu"), port_cfg(cfg),
        backend=backend, device="cpu", **kw)
    r = ref.run([ref_engine.StreamRequest(spikes=planes[:, i])
                 for i in range(5)])
    p = port.run([engine.StreamRequest(spikes=planes[:, i])
                  for i in range(5)])
    assert [x.request_id for x in p] == [x.request_id for x in r]
    for a, b in zip(r, p):
        assert (b.disposition, b.prediction, b.steps) == (
            a.disposition, a.prediction, a.steps)
        assert (b.disposition, b.steps) == ("ok", T)
        np.testing.assert_array_equal(b.spike_counts, a.spike_counts)
        np.testing.assert_array_equal(b.events_per_layer, a.events_per_layer)
        assert b.energy_pj == a.energy_pj
    assert sum(float(x.spike_counts.sum()) for x in p) > 0
    assert all(x.events_per_layer[1] > 0 for x in p)
    # signed planes stage as int8 values in -1..1
    if polarity == "signed":
        assert int(port._ring["values"].min()) == -1


@pytest.mark.parametrize("deadline_ms", [5.0, 0.0])
def test_serve_builds_the_reference_slos(monkeypatch, capsys, deadline_ms):
    """``--deadline-ms`` sets the latency SLO's p99 target, as the
    reference launcher does (1 s without a deadline)."""
    built = []

    class Recording(engine.SNNStreamEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            built.append(self)

    monkeypatch.setattr(serve, "SNNStreamEngine", Recording)
    serve.main(TINY + ["--deadline-ms", str(deadline_ms)])
    capsys.readouterr()
    (eng,) = built
    target = deadline_ms / 1e3 if deadline_ms > 0 else 1.0
    want = ref_obs.default_slos(p99_target_s=target)
    assert [type(s).__name__ for s in eng.slos] == [
        type(s).__name__ for s in want]
    assert [s.name for s in eng.slos] == [s.name for s in want]
    latency = [s for s in eng.slos if s.name == "latency_p99"]
    assert [s.target_s for s in latency] == [target]
    health = eng.health()["slos"]
    assert [s["name"] for s in health] == [s.name for s in want]
    assert [s.get("target_s") for s in health] == [
        getattr(s, "target_s", None) for s in want]
