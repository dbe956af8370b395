"""Port parity: ``repro_torch.analysis.contracts`` against the contract
cases of the reference's ``tests/test_analysis.py``.

A graph capture is the port's compile: the recompile detector counts the
trainer step's captures (on the CPU its static-buffer set-ups, one per
batch signature) and the serving engine's, whose ring growth extends its
own allowlist.  Donation is declared (``donate_argnums``) and checked at
run time as storages written in place.  The AER bounds report equals the
reference's value for value."""

import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.analysis import contracts as ref_contracts
from repro.configs.collision_snn import CONFIG as REF_CONFIG
from repro_torch import optim
from repro_torch.analysis import (
    ContractViolation,
    RecompileDetector,
    aer_bounds_report,
    check_aer_bounds,
    donation_report,
    runtime_donation_check,
    verify_donation,
)
from repro_torch.analysis import contracts
from repro_torch.configs.collision_snn import CONFIG
from repro_torch.core import snn
from repro_torch.events import aer
from repro_torch.serving import snn_engine as engine
from repro_torch.train import loop


class _Linear:
    """A least model of the trainer's interface: squared error of x @ w."""

    def init(self, seed):
        g = torch.Generator().manual_seed(seed)
        return {"w": torch.randn((6, 3), generator=g)}

    def loss(self, params, batch):
        err = batch["x"] @ params["w"] - batch["y"]
        value = torch.mean(err * err)
        return value, {"loss": value.detach()}


def _trainer(donate=True):
    return loop.Trainer(_Linear(), optim.sgd(0.1), donate=donate)


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": torch.from_numpy(rng.standard_normal((n, 6), np.float32)),
            "y": torch.from_numpy(rng.standard_normal((n, 3), np.float32))}


# ------------------------------------------------------------ recompile detector
def test_recompile_detector_catches_shape_unstable_fn():
    tr = _trainer()
    state = tr.init_state(0)
    with RecompileDetector() as det:
        det.track("step", tr.step_fn, allowed=1)  # cold start
        for n in (4, 8, 16):  # shape-unstable: one capture per shape
            state, _ = tr.step_fn(state, _batch(n))
    assert det.cache_growth("step") == 3
    assert det.backend_compiles == 3
    assert det.unexpected()
    with pytest.raises(ContractViolation):
        det.raise_on_unexpected()


def test_recompile_detector_clean_on_stable_shapes():
    tr = _trainer()
    state, _ = tr.step_fn(tr.init_state(0), _batch(8))  # warm outside
    with RecompileDetector(max_backend_compiles=0) as det:
        det.track("step", tr.step_fn, allowed=0)
        for i in range(5):
            state, _ = tr.step_fn(state, _batch(8, seed=i))
    rep = det.report()
    assert rep["tracked"]["step"]["unexpected"] == 0
    assert det.unexpected() == [] and det.backend_compiles == 0


def test_recompile_detector_freezes_growth_at_exit():
    tr = _trainer()
    state, _ = tr.step_fn(tr.init_state(0), _batch(4))
    with RecompileDetector() as det:
        det.track("step", tr.step_fn, allowed=0)
    tr.step_fn(state, _batch(16))  # after the region: must not count
    assert det.cache_growth("step") == 0
    assert det.unexpected() == [] and det.backend_compiles == 0


def test_engine_capture_contract_allows_ring_growth():
    """The engine's own allowlist (cold start, one capture per ring
    growth) extends the tracked budget; a capture beyond it is caught."""
    eng = types.SimpleNamespace(graph_captures=0, _captures_expected=1)
    with RecompileDetector() as det:
        det.track("chunk", eng, allowed=1)  # cold start
        eng.graph_captures += 1  # the first dispatch captures
        eng._captures_expected += 1  # _grow_ring: a new ring input
        eng.graph_captures += 1
    assert det.cache_growth("chunk") == 2 and det.allowed("chunk") == 2
    assert det.unexpected() == []
    eng.graph_captures += 1  # after the region: frozen
    assert det.cache_growth("chunk") == 2
    with RecompileDetector() as det:
        det.track("chunk", eng, allowed=0)
        eng.graph_captures += 1  # no ring growth: a steady re-capture
    assert det.report()["tracked"]["chunk"]["unexpected"] == 1
    with pytest.raises(ContractViolation, match="chunk"):
        det.raise_on_unexpected()
    # the real engine reports the same two counts (the CPU never captures)
    cfg = snn.SNNConfig(layer_sizes=(64, 24, 2), num_steps=6)
    params = snn.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    real = engine.SNNStreamEngine(params, cfg, num_slots=2, chunk_steps=3,
                                  device="cpu")
    assert contracts._cache_size(real) == 0
    assert contracts._own_allowance(real) == 1


# ------------------------------------------------------------------ donation
def test_donation_report_and_verify():
    tr = _trainer()
    args = (tr.init_state(0), _batch(8))
    rep = verify_donation(tr.step_fn, args, expect_donated=[0])
    assert rep["donated_argnums"] == [0]
    assert rep["leaf_counts"] == [2, 2] and rep["donated_flat"] == [0, 1]
    with pytest.raises(ContractViolation):
        verify_donation(tr.step_fn, args, expect_donated=[0, 1])
    keep = _trainer(donate=False)
    assert donation_report(keep.step_fn, *args)["donated_argnums"] == []
    with pytest.raises(ContractViolation):
        verify_donation(keep.step_fn, args, expect_donated=[0])


def test_runtime_donation_check():
    tr = _trainer()
    state = tr.init_state(0)
    w0 = state.params["w"].clone()
    out, _ = runtime_donation_check(tr.step_fn, (state, _batch(8)), donated=[0])
    assert out.params["w"].data_ptr() == state.params["w"].data_ptr()
    assert not torch.equal(state.params["w"], w0)  # consumed: written in place

    keep = _trainer(donate=False)
    s2 = keep.init_state(0)
    with pytest.raises(ContractViolation):
        runtime_donation_check(keep.step_fn, (s2, _batch(8)), donated=[0])
    assert torch.equal(s2.params["w"], w0)


def test_engine_chunk_donation_contract():
    # the contract the tick relies on: states + meta are updated in place,
    # weights (prepared) and the spike ring are not
    cfg = snn.SNNConfig(layer_sizes=(64, 24, 2), num_steps=6)
    params = snn.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    eng = engine.SNNStreamEngine(params, cfg, num_slots=2, chunk_steps=3,
                                 device="cpu")
    args = (eng._prepared, eng._states, eng._ring, eng._meta, eng._stats)
    rep = donation_report(eng._chunk, *args)
    assert rep["donated_argnums"] == [1, 3]
    ring = [x.clone() for x in eng._ring.values()]
    runtime_donation_check(eng._chunk, args, donated=[1, 3])
    assert all(torch.equal(a, b) for a, b in zip(ring, eng._ring.values()))
    with pytest.raises(ContractViolation, match=r"\[2\]"):
        runtime_donation_check(eng._chunk, args, donated=[2])


# ------------------------------------------------------------------ AER bounds
def test_aer_bounds_collision_config_clean():
    assert CONFIG.layer_sizes == REF_CONFIG.layer_sizes
    assert check_aer_bounds(CONFIG.layer_sizes) == []
    rep = aer_bounds_report(CONFIG.layer_sizes, num_steps=CONFIG.num_steps)
    assert rep["ok"]
    assert [lay["addr_fits"] for lay in rep["layers"]] == [True] * 3
    assert rep == ref_contracts.aer_bounds_report(
        REF_CONFIG.layer_sizes, num_steps=REF_CONFIG.num_steps)
    caps = {0: 512, 1: 64}
    assert aer_bounds_report(CONFIG.layer_sizes, caps) == \
        ref_contracts.aer_bounds_report(REF_CONFIG.layer_sizes, caps)


@pytest.mark.parametrize("case", ["capacity", "width"])
def test_aer_bounds_flags_overflow(case):
    """An int32 count lane one past its range, and a layer one address
    wider than int32 can index: both flagged, as the reference flags
    them."""
    big = 2**31 + 1
    sizes, caps = ((4096, 512, 2), [4096, big]) if case == "capacity" else (
        (big,), None)
    rep = aer_bounds_report(sizes, caps, num_steps=25)
    assert not rep["ok"]
    assert rep == ref_contracts.aer_bounds_report(sizes, caps, num_steps=25)
    got = check_aer_bounds(sizes, caps)
    assert got and got == ref_contracts.check_aer_bounds(sizes, caps)


def test_aer_bounds_follow_addr_dtype_for():
    for width in (2, 4096, 32767, 32768, 70_000):
        rep = aer_bounds_report([width])["layers"][0]
        assert rep["addr_dtype"] == str(aer.addr_dtype_for(width)).removeprefix(
            "torch.")
        assert rep["addr_dtype"] == np.dtype(
            ref_contracts.aer_bounds_report([width])["layers"][0]["addr_dtype"]
        ).name
        assert rep["max_addr"] == int(jnp.iinfo(jnp.dtype(rep["addr_dtype"])).max)
