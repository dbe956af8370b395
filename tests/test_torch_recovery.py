"""Port parity: crash-safe engine state and deadline-aware preemption
(``snapshot``/``restore``, ``snapshot_auto``/``restore_latest_snapshot``,
``_park_slot``/``_resume_slot``), case by case after
``tests/test_recovery.py``, and the trainer's full-state resume: a
restore writes into the static step's buffers (``StaticStep.load``), so
no state buffer moves.

The port's own snapshot -> restore must be bit-exact: a restored engine
finishes every window with the results of a run that was never
interrupted.  A snapshot directory written by the reference engine
restores into the port, which then finishes with the reference's
results.  Restore and resume write into the engine's existing buffers,
so no chunk buffer moves.  Shapes are REF_CFG's (64-24-2, T = 20, 3
slots, Tc = 5) unless a case says otherwise; everything runs on the
CPU, the kill cases in a subprocess."""

import dataclasses
import os
import re
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import np_tree, params_pair, port_cfg, spikes
from repro import faults as ref_faults
from repro.core import snn as ref_snn
from repro.serving import snn_engine as ref_engine
from repro_torch import faults
from repro_torch.checkpoint import CheckpointManager, publish_array_dir
from repro_torch.core import snn as port_snn
from repro_torch.serving import snn_engine as engine

REF_CFG = ref_snn.SNNConfig(layer_sizes=(64, 24, 2), num_steps=20)
REPO = os.path.join(os.path.dirname(__file__), "..")
BACKENDS = {"torch": "jnp", "fused": "fused"}  # port -> reference
_PARAMS = {}


def _params():
    """(reference, port) params with equal values, the output layer's
    threshold lowered so that it spikes."""
    if not _PARAMS:
        tree = {n: {k: v.copy() for k, v in lp.items()}
                for n, lp in np_tree(params_pair(REF_CFG, seed=0)[0]).items()}
        tree[f"layer{REF_CFG.num_layers - 1}"]["threshold"][:] = 0.1
        _PARAMS["ref"] = {n: {k: jnp.asarray(v) for k, v in lp.items()}
                          for n, lp in tree.items()}
        _PARAMS["port"] = port_snn.params_from_numpy(tree, "cpu")
    return _PARAMS["ref"], _PARAMS["port"]


def _mk(backend="torch", **kw):
    kw = {"num_slots": 3, "chunk_steps": 5, "seed": 0, **kw}
    return engine.SNNStreamEngine(_params()[1], port_cfg(REF_CFG),
                                  backend=backend, device="cpu", **kw)


def _mk_ref(backend="torch", **kw):
    kw = {"num_slots": 3, "chunk_steps": 5, "seed": 0, **kw}
    return ref_engine.SNNStreamEngine(_params()[0], REF_CFG,
                                      backend=BACKENDS[backend], **kw)


def _train(rate, seed, T=None):
    rng = np.random.default_rng(seed)
    return spikes(rng, (T or REF_CFG.num_steps, REF_CFG.layer_sizes[0]), rate)


def _by_rid(results):
    return {r.request_id: r for r in results}


def _assert_result_equal(a, b):
    np.testing.assert_array_equal(a.spike_counts, b.spike_counts)
    np.testing.assert_array_equal(a.events_per_layer, b.events_per_layer)
    assert a.prediction == b.prediction
    assert a.energy_pj == b.energy_pj
    assert a.steps == b.steps
    assert (a.disposition, a.fault, a.parked) == (
        b.disposition, b.fault, b.parked)


def _assert_all_equal(got, want):
    assert sorted(got) == sorted(want)
    for rid in want:
        _assert_result_equal(got[rid], want[rid])


def _buffers(eng):
    out = {f"u{i}": st.u for i, st in enumerate(eng._states)}
    out.update({f"refrac{i}": st.refrac for i, st in enumerate(eng._states)})
    out.update({f"meta.{k}": v for k, v in eng._meta.items()})
    out.update({f"ring.{k}": v for k, v in eng._ring.items()})
    out["stats"] = eng._stats
    return {k: v.data_ptr() for k, v in out.items()}


def _oracle(trains, backend="torch", **kw):
    eng = _mk(backend, **kw)
    return _by_rid(eng.run([engine.StreamRequest(spikes=t) for t in trains]))


# ------------------------------------------------- snapshot / warm restart
@pytest.mark.parametrize("backend", ["torch", "fused"])
def test_snapshot_warm_restart_is_bit_exact(tmp_path, backend):
    """Snapshot with windows in flight and requests queued, restore into a
    fresh engine, finish: bit-identical to an uninterrupted run (and to
    the reference's results)."""
    trains = [_train(0.3, s) for s in range(7)]
    oracle = _oracle(trains, backend)
    eng1 = _mk(backend)
    for t in trains:
        eng1.submit(engine.StreamRequest(spikes=t))
    early = []
    for _ in range(3):
        early.extend(eng1.poll())
    assert not eng1.idle() and eng1.queue_depth() > 0
    path = eng1.snapshot(str(tmp_path / "snap"))
    eng2 = _mk(backend)
    eng2.restore(path)
    got = _by_rid(early + eng2.drain())
    _assert_all_equal(got, oracle)
    ref = _by_rid(_mk_ref(backend).run(
        [ref_engine.StreamRequest(spikes=t) for t in trains]))
    for rid in ref:
        np.testing.assert_array_equal(got[rid].spike_counts,
                                      ref[rid].spike_counts)
        np.testing.assert_array_equal(got[rid].events_per_layer,
                                      ref[rid].events_per_layer)
        assert got[rid].prediction == ref[rid].prediction


def test_snapshot_preserves_queue_order_and_deadlines(tmp_path):
    eng1 = _mk(num_slots=2)
    eng1.submit(engine.StreamRequest(spikes=_train(0.3, 0)))
    eng1.submit(engine.StreamRequest(spikes=_train(0.3, 1)))
    eng1.poll()
    eng1.submit(engine.StreamRequest(spikes=_train(0.3, 2), priority=0))
    eng1.submit(engine.StreamRequest(spikes=_train(0.3, 3), priority=5,
                                     deadline_s=30.0))
    path = eng1.snapshot(str(tmp_path / "snap"))
    eng2 = _mk(num_slots=2)
    eng2.restore(path)
    assert eng2.queue_depth() == 2
    got = _by_rid(eng2.drain())
    assert got[3].queue_wait_s < got[2].queue_wait_s
    assert got[3].deadline_s == pytest.approx(30.0, abs=1.0)
    assert not got[3].deadline_missed


def test_restore_geometry_mismatch_raises(tmp_path):
    eng = _mk()
    eng.submit(engine.StreamRequest(spikes=_train(0.3, 0)))
    eng.poll()
    path = eng.snapshot(str(tmp_path / "snap"))
    with pytest.raises(ValueError, match="geometry"):
        _mk(num_slots=2).restore(path)


def test_restore_rejects_non_snapshot_dir(tmp_path):
    p = publish_array_dir(str(tmp_path), "notasnap",
                          {"a0": np.zeros(4, np.float32)},
                          {"kind": "something_else"})
    with pytest.raises(ValueError, match="not an engine snapshot"):
        _mk().restore(p)


def test_snapshot_auto_rotation_and_corrupt_fallback(tmp_path):
    trains = [_train(0.3, s) for s in range(5)]
    oracle = _oracle(trains)
    eng1 = _mk()
    for t in trains:
        eng1.submit(engine.StreamRequest(spikes=t))
    eng1.poll()
    eng1.snapshot_auto(str(tmp_path))
    eng1.poll()
    eng1.snapshot_auto(str(tmp_path))
    snaps = sorted(d for d in os.listdir(tmp_path) if d.startswith("snap_"))
    assert snaps == ["snap_000001", "snap_000002"]
    faults.corrupt_checkpoint(str(tmp_path))
    eng2 = _mk()
    with pytest.warns(UserWarning, match="falling back"):
        restored = eng2.restore_latest_snapshot(str(tmp_path))
    assert restored is not None and restored.endswith("snap_000001")
    assert eng2.metrics_snapshot()[
        "engine.faults.checkpoint_fallback"]["value"] == 1
    _assert_all_equal(_by_rid(eng2.drain()), oracle)


def test_snapshot_auto_keep_n_prunes(tmp_path):
    eng = _mk()
    eng.submit(engine.StreamRequest(spikes=_train(0.3, 0)))
    for _ in range(5):
        eng.poll()
        eng.snapshot_auto(str(tmp_path), keep_n=3)
    snaps = sorted(d for d in os.listdir(tmp_path) if d.startswith("snap_"))
    assert len(snaps) == 3
    assert snaps[-1] == "snap_000005"


def test_restore_latest_snapshot_empty_dir_is_none(tmp_path):
    assert _mk().restore_latest_snapshot(str(tmp_path / "nothere")) is None


def test_snapshot_uses_the_reference_format(tmp_path):
    """The same engine state snapshotted by both packages: the same array
    names, shapes and dtypes (the generator's state the one difference)
    and the same manifest keys and geometry."""
    trains = [_train(0.3, s) for s in range(5)]
    paths = []
    for eng, mod, name in ((_mk_ref(preempt=True), ref_engine, "ref"),
                           (_mk(preempt=True), engine, "port")):
        for t in trains[:3]:
            eng.submit(mod.StreamRequest(spikes=t))
        eng.poll()
        eng.submit(mod.StreamRequest(spikes=trains[3], priority=5,
                                     deadline_s=50.0))
        eng.submit(mod.StreamRequest(spikes=trains[4]))
        eng.poll()
        assert eng.preempt_parked_depth() == 1
        paths.append(eng.snapshot(str(tmp_path / name)))
    from repro_torch.checkpoint import load_array_dir

    (r_arr, r_man), (p_arr, p_man) = (load_array_dir(p) for p in paths)
    assert set(r_arr) - {"rng_key"} == set(p_arr) - {"rng_state"}
    for k in set(r_arr) - {"rng_key"}:
        assert (p_arr[k].shape, p_arr[k].dtype) == (
            r_arr[k].shape, r_arr[k].dtype), k
    assert set(p_man) == set(r_man)
    assert p_man["geometry"] == r_man["geometry"]
    for key in ("slots", "queue", "parked", "preempt_parked",
                "pending_results"):
        assert [set(d) for d in p_man[key]] == [set(d) for d in r_man[key]]
    assert r_man["backend"] == "jnp" and p_man["backend"] == "torch"
    for k in ("state0_u", "state1_u", "ring_counts", "meta_done",
              "meta_total", "slot_done", "slot_events", "pp0_u0",
              "pp0_ring_addrs"):
        np.testing.assert_allclose(p_arr[k], r_arr[k], rtol=1e-5, atol=1e-5)


# --------------------------------------- the reference's snapshot in the port
def _ref_snapshot_mid_run(tmp_path, trains, image):
    """A reference engine mid-run with resident windows (one an image
    request, its train already encoded in the ring), a queue, a parked
    priority request and a preempt-parked window; returns the snapshot's
    path and the reference's results, delivered and after its own
    restore."""
    eng = _mk_ref(preempt=True,
                  admission=ref_faults.AdmissionPolicy(max_queue_depth=3))
    eng.submit(ref_engine.StreamRequest(image=image))
    for t in trains[:2]:
        eng.submit(ref_engine.StreamRequest(spikes=t))
    early = eng.poll()
    eng.submit(ref_engine.StreamRequest(spikes=trains[2], priority=3,
                                        deadline_s=60.0))  # preempts
    early += eng.poll()
    for i, t in enumerate(trains[3:7]):  # 3 queue, the fourth parks
        eng.submit(ref_engine.StreamRequest(spikes=t, priority=int(i == 3)))
    assert eng.preempt_parked_depth() == 1 and eng.parked_depth() == 1
    assert eng.queue_depth() == 3
    path = eng.snapshot(str(tmp_path / "refsnap"))
    twin = _mk_ref(preempt=True)
    twin.restore(path)
    return path, _by_rid(early), _by_rid(early + twin.drain())


def test_reference_snapshot_restores_into_the_port(tmp_path):
    """A snapshot directory the reference engine wrote (npz + manifest)
    restores into the port, which finishes every request with the
    reference's results: spike trains and the image request admitted
    before the snapshot alike."""
    trains = [_train(0.3, s) for s in range(7)]
    image = np.random.default_rng(9).random(64).astype(np.float32)
    path, early, ref = _ref_snapshot_mid_run(tmp_path, trains, image)
    port = _mk(preempt=True)
    port.restore(path)
    assert port.preempt_parked_depth() == 1 and port.parked_depth() == 1
    assert port.queue_depth() == 3
    assert port.stall_snapshot()["parked_rids"] == [7]
    got = _by_rid(list(early.values()) + port.drain())
    assert sorted(got) == sorted(ref) == list(range(8))
    for rid, a in ref.items():
        b = got[rid]
        assert (b.disposition, b.fault, b.parked, b.prediction, b.steps) == (
            a.disposition, a.fault, a.parked, a.prediction, a.steps), rid
        np.testing.assert_array_equal(b.spike_counts, a.spike_counts)
        np.testing.assert_array_equal(b.events_per_layer, a.events_per_layer)
        assert b.energy_pj == pytest.approx(a.energy_pj, rel=1e-9)
    assert got[7].parked and got[0].events_per_layer[0] > 0
    trace = [s for s in port.trace.spans() if s.name == "restore"]
    assert trace[0].args["backend"] == "torch"  # the reference's "jnp"


def test_reference_rng_key_seeds_the_generator(tmp_path):
    """A reference snapshot holds a threefry key, not a torch generator
    state: the port seeds its generator from the key's words (so image
    draws after such a restore differ from the reference's by design)."""
    eng = _mk_ref()
    eng.submit(ref_engine.StreamRequest(spikes=_train(0.3, 0)))
    eng.poll()
    path = eng.snapshot(str(tmp_path / "snap"))
    from repro_torch.checkpoint import load_array_dir

    key = load_array_dir(path)[0]["rng_key"]
    port = _mk()
    port.restore(path)
    want = torch.Generator().manual_seed(engine._seed_from_key(key))
    assert torch.equal(port._gen.get_state(), want.get_state())
    assert engine._seed_from_key(np.array([1, 2], np.uint32)) == (1 << 32) + 2


# ------------------------------------------------- in place, on the buffers
def test_restore_and_resume_write_in_place(tmp_path):
    """Restore copies into the buffers that exist (the graph holds their
    addresses on the card); park and resume move rows, never buffers."""
    trains = [_train(0.3, s) for s in range(5)]
    eng1 = _mk(preempt=True)
    for t in trains[:3]:
        eng1.submit(engine.StreamRequest(spikes=t))
    eng1.poll()
    before = _buffers(eng1)
    eng1.submit(engine.StreamRequest(spikes=trains[3], priority=4,
                                     deadline_s=60.0))
    eng1.poll()  # parks one window
    assert eng1.preempt_parked_depth() == 1
    assert _buffers(eng1) == before
    path = eng1.snapshot(str(tmp_path / "snap"))
    eng2 = _mk(preempt=True)
    fresh = _buffers(eng2)
    eng2.restore(path)
    assert _buffers(eng2) == fresh
    eng2.submit(engine.StreamRequest(spikes=trains[4]))
    while not eng2.idle():
        eng2.poll()
        assert _buffers(eng2) == fresh
    assert eng2.metrics_snapshot()["engine.preempt.resumed"]["value"] == 1
    assert eng2.steady_state_recompiles() == 0


def test_restore_of_a_longer_ring_grows_it_once(tmp_path):
    """A snapshot taken after the ring grew restores into a fresh engine
    through ``_grow_ring`` (the one allowed re-capture site); only the
    ring moves, and the results are the uninterrupted run's."""
    long = _train(0.3, 40, T=33)
    trains = [_train(0.3, s) for s in range(3)] + [long]
    oracle = _by_rid(_mk().run(
        [engine.StreamRequest(spikes=t, num_steps=t.shape[0])
         for t in trains]))
    eng1 = _mk()
    for t in trains:
        eng1.submit(engine.StreamRequest(spikes=t, num_steps=t.shape[0]))
    early = []
    for _ in range(6):
        early.extend(eng1.poll())
    assert eng1._ring_steps == 33 and not eng1.idle()
    path = eng1.snapshot(str(tmp_path / "snap"))
    eng2 = _mk()
    fresh = _buffers(eng2)
    grows = []
    real_grow = eng2._grow_ring
    eng2._grow_ring = lambda T: (grows.append(T), real_grow(T))
    eng2.restore(path)
    del eng2._grow_ring
    now = _buffers(eng2)
    assert sorted(k for k in fresh if now[k] != fresh[k]) == [
        "ring.addrs", "ring.counts", "ring.values"]
    assert eng2._ring_steps == 33 and grows == [33]
    _assert_all_equal(_by_rid(early + eng2.drain()), oracle)


def test_restore_of_a_shorter_ring_fills_its_head(tmp_path):
    """A snapshot with a shorter ring restores into an engine whose ring
    already grew: the snapshot fills the head, the rest is zeroed, and no
    buffer moves."""
    trains = [_train(0.3, s) for s in range(4)]
    oracle = _oracle(trains)
    eng1 = _mk()
    for t in trains:
        eng1.submit(engine.StreamRequest(spikes=t))
    early = eng1.poll() + eng1.poll()
    path = eng1.snapshot(str(tmp_path / "snap"))
    eng2 = _mk()
    eng2.run([engine.StreamRequest(spikes=_train(0.3, 9, T=30),
                                   num_steps=30)])
    grown = _buffers(eng2)
    eng2.restore(path)
    assert _buffers(eng2) == grown and eng2._ring_steps == 30
    assert not eng2._ring["counts"][:, 25:].any()
    _assert_all_equal(_by_rid(early + eng2.drain()), oracle)


# ------------------------------------------------- deadline-aware preemption
def test_preemption_parks_loosest_and_stays_bit_exact():
    trains = [_train(0.3, s) for s in range(4)]
    oracle = _oracle(trains)
    eng = _mk(preempt=True)
    eng.submit(engine.StreamRequest(spikes=trains[0]))
    eng.submit(engine.StreamRequest(spikes=trains[1], deadline_s=1e4))
    eng.submit(engine.StreamRequest(spikes=trains[2], deadline_s=1e4))
    eng.poll()
    eng.submit(engine.StreamRequest(spikes=trains[3], priority=5,
                                    deadline_s=0.5))
    eng.poll()
    assert eng.preempt_parked_depth() == 1
    stall = eng.stall_snapshot()
    assert stall["preempt_parked_depth"] == 1
    assert stall["preempt_parked"][0]["rid"] == 0
    assert 0 < stall["preempt_parked"][0]["done"] < REF_CFG.num_steps
    diag = eng.health()["diagnosis"]
    assert diag["preempt_parked_depth"] == 1 and "preempt_thrash" in diag
    got = _by_rid(eng.drain())
    snap = eng.metrics_snapshot()
    assert snap["engine.preempt.parked"]["value"] >= 1
    assert snap["engine.preempt.resumed"]["value"] >= 1
    assert snap["engine.preempt.park_s"]["count"] >= 1
    assert snap["engine.preempt.restore_s"]["count"] >= 1
    _assert_all_equal(got, oracle)


def test_preemption_equals_the_reference():
    """The same arrivals with priorities and deadlines through both
    engines with ``preempt=True``: the same parks and resumes, the same
    results request by request."""
    trains = [_train(0.3, s) for s in range(8)]
    plan = [(0, None), (0, 1e4), (1, 1e4), (5, 50.0), (0, None), (7, 40.0),
            (2, 1e4), (0, None)]
    out = []
    for eng, mod in ((_mk_ref(preempt=True), ref_engine),
                     (_mk(preempt=True), engine)):
        results = []
        for i, t in enumerate(trains):
            prio, dl = plan[i]
            eng.submit(mod.StreamRequest(spikes=t, priority=prio,
                                         deadline_s=dl))
            if i >= 2:
                results += eng.poll()
        results += eng.drain()
        snap = eng.metrics_snapshot()
        out.append((_by_rid(results), snap["engine.preempt.parked"]["value"],
                    snap["engine.preempt.resumed"]["value"]))
    (ref, r_park, r_res), (port, p_park, p_res) = out
    assert (p_park, p_res) == (r_park, r_res) and p_park >= 2
    for rid, a in ref.items():
        b = port[rid]
        assert (b.prediction, b.steps, b.disposition) == (
            a.prediction, a.steps, a.disposition)
        np.testing.assert_array_equal(b.spike_counts, a.spike_counts)
        np.testing.assert_array_equal(b.events_per_layer, a.events_per_layer)
    _assert_all_equal(port, _oracle(trains))


def test_backpressure_with_preemption_equals_the_reference():
    """A bounded queue, priority parking and preemption together."""
    trains = [_train(0.25, 50 + s) for s in range(10)]
    out = []
    for eng, mod, pol in (
            (_mk_ref, ref_engine, ref_faults.AdmissionPolicy),
            (_mk, engine, faults.AdmissionPolicy)):
        e = eng(preempt=True, admission=pol(max_queue_depth=2))
        results = []
        for i, t in enumerate(trains):
            e.submit(mod.StreamRequest(spikes=t, priority=i % 3,
                                       deadline_s=100.0 - i))
            if i % 3 == 2:
                results += e.poll()
        results += e.drain()
        out.append((_by_rid(results), e.shed_rate(),
                    e.metrics_snapshot()["engine.preempt.parked"]["value"]))
    (ref, r_shed, r_park), (port, p_shed, p_park) = out
    assert (p_shed, p_park) == (r_shed, r_park)
    assert p_shed > 0 and p_park > 0
    for rid, a in ref.items():
        b = port[rid]
        assert (b.disposition, b.fault, b.parked, b.prediction) == (
            a.disposition, a.fault, a.parked, a.prediction), rid
        np.testing.assert_array_equal(b.spike_counts, a.spike_counts)
        np.testing.assert_array_equal(b.events_per_layer, a.events_per_layer)


def test_no_preemption_without_flag():
    eng = _mk()
    for s in range(3):
        eng.submit(engine.StreamRequest(spikes=_train(0.3, s)))
    eng.poll()
    eng.submit(engine.StreamRequest(spikes=_train(0.3, 3), priority=9,
                                    deadline_s=0.01))
    eng.drain()
    assert eng.metrics_snapshot()["engine.preempt.parked"]["value"] == 0


def test_preemption_ties_do_not_thrash():
    eng = _mk(preempt=True)
    for s in range(3):
        eng.submit(engine.StreamRequest(spikes=_train(0.3, s), priority=5))
    eng.poll()
    eng.submit(engine.StreamRequest(spikes=_train(0.3, 3), priority=5))
    eng.drain()
    assert eng.metrics_snapshot()["engine.preempt.parked"]["value"] == 0


def test_preempted_state_survives_snapshot(tmp_path):
    trains = [_train(0.3, s) for s in range(4)]
    oracle = _oracle(trains)
    eng1 = _mk(preempt=True)
    eng1.submit(engine.StreamRequest(spikes=trains[0]))
    eng1.submit(engine.StreamRequest(spikes=trains[1], deadline_s=1e4))
    eng1.submit(engine.StreamRequest(spikes=trains[2], deadline_s=1e4))
    eng1.poll()
    eng1.submit(engine.StreamRequest(spikes=trains[3], priority=5,
                                     deadline_s=5.0))
    eng1.poll()
    assert eng1.preempt_parked_depth() == 1
    path = eng1.snapshot(str(tmp_path / "snap"))
    eng2 = _mk(preempt=True)
    eng2.restore(path)
    assert eng2.preempt_parked_depth() == 1
    _assert_all_equal(_by_rid(eng2.drain()), oracle)


# ------------------------------------------------------- SIGKILL chaos
_KILL_CKPT_SCRIPT = textwrap.dedent("""
    import sys
    sys.path.insert(0, "src")
    import numpy as np
    from repro_torch.checkpoint import CheckpointManager

    mgr = CheckpointManager(sys.argv[1], keep_n=3)
    step = 0
    while True:
        step += 1
        mgr.save(step, {
            "w": np.full((512, 64), float(step), np.float32),
            "step": np.asarray(step, np.int64),
        })
        print(step, flush=True)
""")


def test_sigkill_mid_save_never_corrupts_restore_latest(tmp_path):
    """SIGKILL a process that checkpoints in a tight loop, at staggered
    moments: ``restore_latest`` in the survivor always gives a tree whose
    leaves come from one step, with no integrity fallback."""
    for trial, extra_delay in enumerate((0.0, 0.05, 0.15)):
        d = str(tmp_path / f"trial{trial}")
        proc = subprocess.Popen(
            [sys.executable, "-c", _KILL_CKPT_SCRIPT, d],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
        )
        try:
            proc.stdout.readline()  # the first save landed
            time.sleep(extra_delay)
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=60)
        assert proc.returncode == -signal.SIGKILL
        mgr = CheckpointManager(d)
        like = {"w": np.zeros((512, 64), np.float32),
                "step": np.asarray(0, np.int64)}
        step, tree = mgr.restore_latest(like)
        assert step is not None
        assert mgr.fallbacks == 0
        np.testing.assert_array_equal(
            tree["w"], np.full((512, 64), float(step), np.float32))
        assert int(tree["step"]) == step
        assert not [f for f in os.listdir(d) if f.startswith(".tmp_")]


_KILL_ENGINE_SCRIPT = textwrap.dedent("""
    import sys
    sys.path.insert(0, "src")
    import numpy as np
    import torch
    from repro_torch.core import snn
    from repro_torch.faults import Fault, FaultInjector, FaultSchedule
    from repro_torch.serving.snn_engine import SNNStreamEngine, StreamRequest

    snap_dir, params_npz = sys.argv[1], sys.argv[2]
    cfg = snn.SNNConfig(layer_sizes=(64, 24, 2), num_steps=20)
    flat = np.load(params_npz)
    tree = {}
    for key in flat.files:
        layer, name = key.split("/")
        tree.setdefault(layer, {})[name] = flat[key]
    params = snn.params_from_numpy(tree, "cpu")
    # kill at tick 2: every window is still mid-flight, so the last
    # snapshot carries the complete outstanding set
    injector = FaultInjector(FaultSchedule(
        faults=(Fault(tick=2, kind="process_kill"),)))
    eng = SNNStreamEngine(params, cfg, num_slots=3, chunk_steps=5, seed=0,
                          backend="torch", injector=injector, device="cpu")
    for s in range(5):
        r = np.random.default_rng(s)
        eng.submit(StreamRequest(spikes=(
            r.random((20, 64)) < 0.3).astype(np.float32)))
    while not eng.idle():
        eng.snapshot_auto(snap_dir)   # before the tick: the kill at
        eng.poll()                    # tick 2 loses nothing
    print("ENGINE_FINISHED_WITHOUT_KILL", flush=True)
""")


def test_process_kill_then_warm_restart_parity(tmp_path):
    """A serving process on the CPU SIGKILLs itself mid-run through the
    ``process_kill`` fault; a fresh engine warm-restarts from the snapshot
    rotation and finishes all five windows bit-identically to a run that
    was never killed."""
    tree = np_tree({n: {k: v for k, v in lp.items()}
                    for n, lp in _params()[0].items()})
    params_npz = str(tmp_path / "params.npz")
    np.savez(params_npz, **{f"{n}/{k}": v for n, lp in tree.items()
                            for k, v in lp.items()})
    snap_dir = str(tmp_path / "snaps")
    proc = subprocess.run(
        [sys.executable, "-c", _KILL_ENGINE_SCRIPT, snap_dir, params_npz],
        cwd=REPO, capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == -signal.SIGKILL, proc.stderr
    assert "ENGINE_FINISHED_WITHOUT_KILL" not in proc.stdout
    trains = [(np.random.default_rng(s).random((20, 64)) < 0.3)
              .astype(np.float32) for s in range(5)]
    oracle = _oracle(trains)
    eng = _mk()
    assert eng.restore_latest_snapshot(snap_dir) is not None
    _assert_all_equal(_by_rid(eng.drain()), oracle)


def test_process_kill_fault_kind_validates():
    f = faults.Fault(tick=2, kind="process_kill")
    assert f in faults.FaultSchedule(faults=(f,)).faults
    with pytest.raises(ValueError, match="needs path"):
        faults.FaultInjector(faults.FaultSchedule(
            faults=(faults.Fault(tick=0, kind="corrupt_checkpoint"),)
        )).begin_tick(None, 0)
    with pytest.raises(ValueError, match="unknown fault kind"):
        faults.Fault(tick=0, kind="bitflip")
    assert faults.FAULT_KINDS == ref_faults.FAULT_KINDS


def test_corrupt_checkpoint_fault_carries_forward_until_save(tmp_path):
    inj = faults.FaultInjector(faults.FaultSchedule(faults=(
        faults.Fault(tick=0, kind="corrupt_checkpoint", path=str(tmp_path)),
    )))
    assert inj.begin_tick(None, 0) == []
    assert len(inj._pending) == 1
    publish_array_dir(str(tmp_path), "snap_000001",
                      {"a0": np.arange(32, dtype=np.float32)}, {"kind": "x"})
    applied = inj.begin_tick(None, 1)
    assert applied and applied[0]["kind"] == "corrupt_checkpoint"
    assert applied[0]["path"].endswith("arrays.npz")


def test_corrupt_checkpoint_flips_the_bytes_the_reference_flips(tmp_path):
    """Same file, same seed: the port's ``corrupt_checkpoint`` writes the
    same bytes as the reference's."""
    paths = []
    for name in ("a", "b"):
        publish_array_dir(str(tmp_path / name), "snap_000001",
                          {"a0": np.arange(4096, dtype=np.float32)},
                          {"kind": "x"})
        paths.append(str(tmp_path / name))
    a = faults.corrupt_checkpoint(paths[0], seed=3)
    b = ref_faults.corrupt_checkpoint(paths[1], seed=3)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_fault_schedule_generate_equals_the_reference():
    kw = dict(ticks=50, num_slots=4, num_layers=2,
              kinds=("nan_membrane", "corrupt_ring", "chunk_exception",
                     "stall"), max_exception_times=3)
    for seed in (0, 7, 123):
        port = faults.FaultSchedule.generate(seed, 12, **kw)
        ref = ref_faults.FaultSchedule.generate(seed, 12, **kw)
        assert ([dataclasses.asdict(f) for f in port.faults]
                == [dataclasses.asdict(f) for f in ref.faults])


# ----------------------------------------------------------- the serve CLI
_CLI = ["--snn", "--batch", "2", "--image-hw", "8", "--hidden", "16",
        "--num-steps", "10", "--chunk-steps", "4", "--device", "cpu"]


def test_serve_cli_sheds_preempts_and_snapshots(tmp_path, capsys):
    """The reference launcher's fault-tolerance flags on the port's CLI:
    the summary splits ``ok | shed | quarantined``, snapshots rotate under
    ``--snapshot-dir``, and ``--restore`` warm-restarts from them, here
    with open-loop arrivals and a bounded drain."""
    from repro_torch.launch import serve

    snaps = tmp_path / "snn-snap"
    serve.main(_CLI + ["--requests", "8", "--max-queue", "2", "--shed",
                       "--preempt", "--snapshot-dir", str(snaps),
                       "--snapshot-every", "0.000001"])
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if x.startswith("snn["))
    assert "(closed-loop) (ok 2 | shed 6 | quarantined 0)" in line
    assert "fault plane: shed 6 (75.0% of submitted)" in out
    assert "crash safety: preempt parked 0 / resumed 0 | snapshots" in out
    assert sorted(os.listdir(snaps))[-1].startswith("snap_")
    serve.main(_CLI + ["--requests", "4", "--snapshot-dir", str(snaps),
                       "--restore", "--arrival-rate", "500",
                       "--drain-timeout", "60"])
    out = capsys.readouterr().out
    assert "snn: warm-restarted from" in out
    assert "(open-loop 500 req/s) (ok 4 | shed 0 | quarantined 0)" in out
    with pytest.raises(SystemExit, match="--restore requires"):
        serve.main(_CLI + ["--requests", "1", "--restore"])


def test_serve_cli_injects_faults(capsys):
    from repro_torch.launch import serve

    serve.main(_CLI + ["--requests", "6", "--inject-faults", "3",
                       "--fault-seed", "1", "--drain-timeout", "60"])
    out = capsys.readouterr().out
    line = next(x for x in out.splitlines() if x.startswith("snn["))
    assert "| shed 0 |" in line
    plane = next(x for x in out.splitlines() if "fault plane:" in x)
    n = {k: int(v) for k, v in re.findall(
        r"(quarantined|injected|retries|demotions) (\d+)", plane)}
    assert 1 <= n["injected"] <= 3 and n["demotions"] == 0
    assert n["quarantined"] + n["retries"] >= 1



# ------------------------------------------------- training full-state resume
def _train_leaves(state):
    from repro_torch.tree import tree_leaves

    return tree_leaves((state.params, state.opt_state))


def test_train_resume_is_bit_exact(tmp_path):
    """train(6) == train(3) / restart / restore / train(3): params, Adam
    state, step, seed and telemetry counters resume exactly (ckpt_every=3,
    the data stream fast-forwarded via start_step), on the static-buffer
    step.  A restore into a trainer that has stepped writes its buffers in
    place: no state buffer moves."""
    from repro_torch.sparse_train import trainer as ev

    tcfg = ev.EventTrainConfig(image_hw=16, num_steps=6, hidden=16)

    def make(ckpt_dir, every):
        return ev.EventTrainer(tcfg, energy_lambda=0.01, ckpt_dir=ckpt_dir,
                               ckpt_every=every, seed=0, device="cpu")

    def run(tr, state, n):
        it = ev.dvs_batches(0, 4, tcfg, start_step=state.step, device="cpu")
        return tr.run(state, it, n, log_fn=lambda _: None)[0]

    # uninterrupted reference: 6 steps straight through
    t_ref = make(str(tmp_path / "ref"), 100)
    s_ref = run(t_ref, t_ref.init_state(0), 6)

    # interrupted: 3 steps, then a fresh trainer restores and finishes
    d = str(tmp_path / "resume")
    t1 = make(d, 3)
    run(t1, t1.init_state(0), 3)
    steps_after_3 = t1.metrics.counter("train.steps").value

    t2 = make(d, 3)  # a restart: no shared python state
    s2 = t2.restore_or_init(1)  # the seed comes back from the checkpoint
    assert s2.step == 3 and t2.rng == 0
    assert t2.metrics.counter("train.steps").value == steps_after_3
    assert t2.metrics.counter("train.energy_pj.total").value == pytest.approx(
        t1.metrics.counter("train.energy_pj.total").value)
    buffers = [x.data_ptr() for x in _train_leaves(s2)]
    s2 = run(t2, s2, 3)
    assert [x.data_ptr() for x in _train_leaves(s2)] == buffers

    assert s_ref.step == s2.step == 6
    for a, b in zip(_train_leaves(s_ref), _train_leaves(s2)):
        assert torch.equal(a, b)
    assert t2.metrics.counter("train.steps").value == 6

    # restore again (step 6) into the trainer that has stepped: in place
    s3 = t2.restore_or_init(1)
    assert s3.step == 6 and [x.data_ptr() for x in _train_leaves(s3)] == buffers
    for a, b in zip(_train_leaves(s_ref), _train_leaves(s3)):
        assert torch.equal(a, b)
    assert t2.step_fn.captures == 1


def test_train_resume_falls_back_past_corrupt_checkpoint(tmp_path):
    """Byte-corrupting the newest training checkpoint degrades the
    recovery point (previous keep-N save) instead of crashing resume."""
    from repro_torch.sparse_train import trainer as ev

    tcfg = ev.EventTrainConfig(image_hw=16, num_steps=6, hidden=16)
    d = str(tmp_path / "ck")
    t1 = ev.EventTrainer(tcfg, ckpt_dir=d, ckpt_every=2, seed=0, device="cpu")
    t1.run(t1.init_state(0), ev.dvs_batches(0, 4, tcfg, device="cpu"), 4,
           log_fn=lambda _: None)
    assert t1.ckpt.all_steps() == [2, 4]

    faults.corrupt_checkpoint(d)  # newest (step 4)
    t2 = ev.EventTrainer(tcfg, ckpt_dir=d, ckpt_every=2, seed=0, device="cpu")
    with pytest.warns(UserWarning, match="falling back"):
        s2 = t2.restore_or_init(1)
    assert s2.step == 2
    assert t2.ckpt.fallbacks == 1
