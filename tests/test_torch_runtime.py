"""Port parity: event extraction, step tables and the chunk runtime (plain
backend and the fused chunk's plain version) against the JAX reference."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import params_pair, port_cfg, spikes, t
from repro.core import neuron as ref_neuron
from repro.core import snn as ref_snn
from repro.events import aer as ref_aer
from repro.events import runtime as ref_runtime
from repro_torch.core import neuron
from repro_torch.events import aer, capacity, runtime
from repro_torch.kernels import snn_chunk as chunk_mod

RNG = np.random.default_rng(11)


@pytest.mark.parametrize("capacity", [1, 7, 40, 64])
@pytest.mark.parametrize("signed", [False, True])
def test_step_events_bit_exact(capacity, signed):
    x = spikes(RNG, (3, 4, 64), 0.3, signed=signed)
    x[0, 0] = 0.0  # a silent plane
    x[1, 1] = 1.0  # a full plane (truncated below capacity 64)
    got = runtime.step_events(t(x), capacity)
    ref = ref_runtime.step_events(jnp.asarray(x), capacity)
    for g, r in zip(got, ref):
        assert g.numpy().dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("K,capacity", [(48, 48), (48, 9), (40000, 6)])
def test_encode_step_table_bit_exact(K, capacity):
    x = spikes(RNG, (2, 5, K), min(0.2, 60 / K), signed=True)
    x[0, 2] = 0.0
    got = runtime.encode_step_table(t(x), capacity)
    ref = ref_runtime.encode_step_table(jnp.asarray(x), capacity)
    assert got.addrs.dtype == (torch.int16 if K < 32768 else torch.int32)
    assert got.values.dtype == torch.int8 and got.counts.dtype == torch.int32
    for g, r in zip(got, ref):
        assert g.numpy().dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    if capacity >= K:  # lossless: the table scatters back to the train
        np.testing.assert_array_equal(
            aer.step_table_to_dense(got, K).numpy(),
            np.asarray(ref_aer.step_table_to_dense(ref, K)),
        )
        np.testing.assert_array_equal(aer.step_table_to_dense(got, K).numpy(), x)


def test_narrow_address_dtype_rejected():
    assert aer.addr_dtype_for(32767) == torch.int16
    assert aer.addr_dtype_for(32768) == torch.int32
    with pytest.raises(ValueError, match="cannot index"):
        runtime.encode_step_table(torch.zeros(2, 40000), 4, addr_dtype=torch.int16)


def _states(ref_cfg, B, *, refrac=False):
    """Nonzero incoming states, as (reference, port) lists."""
    ref, port = [], []
    for n in ref_cfg.layer_sizes[1:]:
        u = RNG.normal(0, 0.3, (B, n)).astype(np.float32)
        r = (RNG.integers(0, 3, (B, n)) if refrac else np.zeros((B, n))).astype(
            np.int32
        )
        ref.append(ref_neuron.NeuronState(jnp.asarray(u), jnp.asarray(r)))
        port.append(neuron.NeuronState(t(u), t(r)))
    return ref, port


def _tables(ref_cfg, Tc, B, rate, *, layout, silent_step=None):
    x = spikes(RNG, (Tc, B, ref_cfg.layer_sizes[0]), rate)
    if silent_step is not None:
        x[silent_step] = 0.0
    table = ref_runtime.encode_step_table(jnp.asarray(x), ref_cfg.layer_sizes[0])
    a, v, c = (np.asarray(z) for z in table)
    if layout == "slot_major":
        a, v, c = a.transpose(1, 0, 2), v.transpose(1, 0, 2), c.T
    return (np.ascontiguousarray(a), np.ascontiguousarray(v),
            np.ascontiguousarray(c))


def _assert_chunk_equal(got, ref):
    states, mem, spk, ev = got
    r_states, r_mem, r_spk, r_ev = ref
    np.testing.assert_array_equal(spk.numpy(), np.asarray(r_spk))
    np.testing.assert_array_equal(ev.numpy(), np.asarray(r_ev))
    np.testing.assert_allclose(mem.numpy(), np.asarray(r_mem), atol=1e-5, rtol=1e-5)
    for st, r_st in zip(states, r_states):
        np.testing.assert_array_equal(st.refrac.numpy(), np.asarray(r_st.refrac))
        np.testing.assert_allclose(
            st.u.numpy(), np.asarray(r_st.u), atol=1e-5, rtol=1e-5
        )


def _run_both(ref_cfg, tables, states, *, layout, active=None,
              port_backend, ref_backend):
    ref_p, port_p = params_pair(ref_cfg)
    a, v, c = tables
    ref_states, port_states = states
    ref = ref_runtime.run_chunk_events(
        ref_p, ref_states, jnp.asarray(a), jnp.asarray(v), jnp.asarray(c),
        ref_cfg, active=None if active is None else jnp.asarray(active),
        backend=ref_backend, layout=layout,
    )
    got = runtime.run_chunk_events(
        port_p, port_states, t(a), t(v), t(c), port_cfg(ref_cfg),
        active=None if active is None else t(active),
        backend=port_backend, layout=layout,
    )
    _assert_chunk_equal(got, ref)
    return got


@pytest.mark.parametrize("layout", ["time_major", "slot_major"])
@pytest.mark.parametrize("refractory", [0, 2])
def test_torch_backend_matches_reference_jnp(layout, refractory):
    ref_cfg = ref_snn.SNNConfig(
        layer_sizes=(48, 16, 2), num_steps=6, refractory_steps=refractory
    )
    _run_both(
        ref_cfg, _tables(ref_cfg, 6, 3, 0.4, layout=layout, silent_step=2),
        _states(ref_cfg, 3, refrac=refractory > 0), layout=layout,
        active=np.float32([1, 0, 1]), port_backend="torch", ref_backend="jnp",
    )


# the reference's own fused-kernel matrix (tests/test_snn_chunk.py), one
# geometry so the interpreted Pallas kernel compiles once per mode
_FUSED_CASES = {
    "rate0": ({}, 0.0, False, None),
    "rate0.3": ({}, 0.3, False, None),
    "rate1": ({}, 1.0, False, None),
    "subtract": ({"reset": "subtract"}, 0.4, False, None),
    "refractory": ({"refractory_steps": 2}, 0.6, True, None),
    "q115": ({"quant_q115": True}, 0.3, False, None),
    "frozen": ({}, 0.5, False, [1.0, 0.0, 1.0, 0.0]),
    "lapicque": ({"neuron_kind": "lapicque"}, 0.3, False, None),
}


@pytest.mark.parametrize("case", sorted(_FUSED_CASES))
def test_fused_plain_version_matches_reference_fused(case):
    kw, rate, refrac, active = _FUSED_CASES[case]
    ref_cfg = ref_snn.SNNConfig(layer_sizes=(40, 12, 2), num_steps=5, **kw)
    layout = "slot_major" if case in ("frozen", "refractory") else "time_major"
    got = _run_both(
        ref_cfg, _tables(ref_cfg, 5, 4, rate, layout=layout),
        _states(ref_cfg, 4, refrac=refrac), layout=layout,
        active=None if active is None else np.float32(active),
        port_backend="fused", ref_backend="fused",
    )
    if active is not None:  # frozen slots: no spikes, no events
        assert not got[2][:, 1].any() and not got[3][:, :, 1].any()


def test_fused_three_layers_matches_torch_backend():
    cfg = port_cfg(ref_snn.SNNConfig(layer_sizes=(40, 20, 10, 2), num_steps=5))
    _, p = params_pair(ref_snn.SNNConfig(layer_sizes=(40, 20, 10, 2)))
    x = t(spikes(RNG, (5, 3, 40), 0.3))
    states = runtime.init_states(cfg, 3)
    a = runtime.run_chunk(p, states, x, cfg, backend="torch")
    b = runtime.run_chunk(p, states, x, cfg, backend="fused")
    np.testing.assert_array_equal(a[2].numpy(), b[2].numpy())
    np.testing.assert_array_equal(a[3].numpy(), b[3].numpy())
    np.testing.assert_allclose(a[1].numpy(), b[1].numpy(), atol=1e-5, rtol=1e-5)


def test_event_forward_matches_reference():
    ref_cfg = ref_snn.SNNConfig(layer_sizes=(48, 16, 2), num_steps=8)
    ref_p, port_p = params_pair(ref_cfg)
    x = spikes(RNG, (8, 2, 48), 0.3)
    mem, spk, ev = runtime.event_forward(port_p, t(x), port_cfg(ref_cfg))
    r_mem, r_spk, r_ev = ref_runtime.event_forward(ref_p, jnp.asarray(x), ref_cfg)
    np.testing.assert_array_equal(spk.numpy(), np.asarray(r_spk))
    np.testing.assert_array_equal(ev.numpy(), np.asarray(r_ev))
    np.testing.assert_allclose(mem.numpy(), np.asarray(r_mem), atol=1e-5, rtol=1e-5)
    pred, _ = runtime.predict_events(port_p, t(x), port_cfg(ref_cfg))
    r_pred, _ = ref_runtime.predict_events(ref_p, jnp.asarray(x), ref_cfg)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(r_pred))


def test_truncating_hidden_capacity_rejected_by_fused():
    ref_cfg = ref_snn.SNNConfig(layer_sizes=(40, 12, 2), num_steps=5)
    _, p = params_pair(ref_cfg)
    cfg = port_cfg(ref_cfg)
    x = t(spikes(RNG, (5, 2, 40), 0.3))
    states = runtime.init_states(cfg, 2)
    with pytest.raises(ValueError, match="cannot truncate hidden"):
        runtime.run_chunk(p, states, x, cfg, capacities=(40, 4), backend="fused")
    runtime.run_chunk(p, states, x, cfg, capacities=(40, 4), backend="torch")
    assert capacity.input_capacity(cfg) == 40
    assert capacity.input_capacity(cfg, (9, 12)) == 9
    with pytest.raises(ValueError):
        capacity.input_capacity(cfg, (9,))


def test_plain_version_skips_out_of_range_addresses_and_counts():
    """Corrupt table entries are skipped, not gathered out of bounds."""
    ref_cfg = ref_snn.SNNConfig(layer_sizes=(40, 12, 2), num_steps=5)
    _, p = params_pair(ref_cfg)
    a, v, c = _tables(ref_cfg, 5, 2, 0.3, layout="slot_major")
    args = ([p[f"layer{i}"][k] for i in range(2)] for k in ("w", "b"))
    w, b = args
    beta = [torch.sigmoid(p[f"layer{i}"]["beta_raw"]) for i in range(2)]
    thr = [p[f"layer{i}"]["threshold"] for i in range(2)]
    u0 = [torch.zeros(2, 12), torch.zeros(2, 2)]
    r0 = [torch.zeros(2, 12, dtype=torch.int32), torch.zeros(2, 2, dtype=torch.int32)]
    act = torch.ones(2)
    clean = chunk_mod.snn_chunk_ref(w, b, beta, thr, u0, r0, t(a), t(v), t(c),
                                    act, layout="slot_major")
    bad_a = t(a).to(torch.int32)
    bad_v = t(v).clone()
    bad_a[0, 1, c[0, 1]] = 999  # past the count: never read
    bad_v[0, 1, c[0, 1]] = 1
    dirty = chunk_mod.snn_chunk_ref(w, b, beta, thr, u0, r0, bad_a, bad_v,
                                    t(c), act, layout="slot_major")
    for x, y in zip(clean[:3], dirty[:3]):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    bad_a[1, 0, 0] = -5  # inside the count: skipped
    mem, spk, ev, u, r = chunk_mod.snn_chunk_ref(
        w, b, beta, thr, u0, r0, bad_a, bad_v, t(c) + 100, act,
        layout="slot_major",
    )
    assert torch.isfinite(mem).all() and all(torch.isfinite(x).all() for x in u)
    assert ev[:, 0].max() == 40  # counts past capacity clamp to C
