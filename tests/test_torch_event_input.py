"""Port parity: the event input path (``aer.merge``,
``runtime.step_events_argsort``, ``runtime.event_forward_aer``) against
the JAX reference on the CPU, where the port's aer kernel runs its plain
version.  Streams and weights are made once with numpy and handed to both;
integer outputs must be equal, membranes within atol = rtol = 1e-5."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _hypothesis_compat import given, settings, st
from _torch_parity import params_pair, port_cfg, spikes, t
from repro.core import snn as ref_snn
from repro.events import aer as ref_aer
from repro.events import runtime as ref_runtime
from repro_torch.events import aer, runtime
from repro_torch.kernels import aer_matmul

RNG = np.random.default_rng(19)


def _streams(dense, capacity):
    """(reference stream, port stream) of one dense train (T, B, N)."""
    ref = ref_aer.dense_to_aer(jnp.asarray(dense), capacity)
    port = aer.EventStream(*(t(np.asarray(x)) for x in ref))
    return ref, port


def _assert_stream_equal(got, ref):
    for g, r in zip(got, ref):
        assert g.numpy().dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def _disjoint_pair(T, B, N, rate):
    a = spikes(RNG, (T, B, N), rate)
    b = spikes(RNG, (T, B, N), rate) * (a == 0)
    return a, b


# ------------------------------------------------------------------ merge
@pytest.mark.parametrize("num_steps", [None, 8])
def test_merge_equals_reference(num_steps):
    """tests/test_events.py::test_merge_streams on both packages."""
    T, N = 8, 30
    a, b = _disjoint_pair(T, 2, N, 0.15)
    ra, pa = _streams(a, T * N)
    rb, pb = _streams(b, T * N)
    kw = dict(num_addrs=N, capacity=2 * T * N, num_steps=num_steps)
    got = aer.merge(pa, pb, **kw)
    _assert_stream_equal(got, ref_aer.merge(ra, rb, **kw))
    np.testing.assert_array_equal(aer.aer_to_dense(got, T, N).numpy(), a + b)


@pytest.mark.parametrize("num_steps", [None, 4])
def test_merge_with_capacity_headroom_equals_reference(num_steps):
    """Output capacity beyond the combined inputs pads with the padding
    convention (tests/test_events.py::test_merge_with_capacity_headroom)."""
    T, N = 4, 8
    a, b = _disjoint_pair(T, 1, N, 0.9)
    ra, pa = _streams(a, int(a.sum()))
    rb, pb = _streams(b, max(int(b.sum()), 1))
    kw = dict(num_addrs=N, capacity=3 * T * N, num_steps=num_steps)
    got = aer.merge(pa, pb, **kw)
    _assert_stream_equal(got, ref_aer.merge(ra, rb, **kw))
    c = int(got.count[0])
    assert got.capacity == 3 * T * N
    assert (got.polarity[0, c:] == 0).all()
    if num_steps is not None:
        assert (got.times[0, c:] == T).all()
    np.testing.assert_array_equal(aer.aer_to_dense(got, T, N).numpy(), a + b)


def test_merge_keeps_the_earliest_events_at_capacity():
    T, N = 6, 12
    a, b = _disjoint_pair(T, 3, N, 0.5)
    ra, pa = _streams(a, T * N)
    rb, pb = _streams(b, T * N)
    kw = dict(num_addrs=N, capacity=9)  # far below the union
    got = aer.merge(pa, pb, **kw)
    _assert_stream_equal(got, ref_aer.merge(ra, rb, **kw))
    assert (got.count == 9).all()


# ------------------------------------------------------ step_events_argsort
def _check_argsort(x, capacity):
    got = runtime.step_events_argsort(t(x), capacity)
    fast = runtime.step_events(t(x), capacity)
    for g, f in zip(got, fast):
        assert g.dtype == f.dtype
        assert torch.equal(g, f)
    if capacity <= x.shape[-1]:  # the reference's argsort needs C <= K
        ref = ref_runtime.step_events_argsort(jnp.asarray(x), capacity)
        for g, r in zip(got, ref):
            assert g.numpy().dtype == np.asarray(r).dtype
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("K,capacity,rate", [
    (1, 1, 0.5), (16, 3, 0.5), (64, 64, 0.3), (64, 9, 0.9), (40, 50, 0.2),
    (128, 17, 0.0), (128, 128, 1.0),
])
@pytest.mark.parametrize("signed", [False, True])
def test_step_events_argsort_equals_reference_and_step_events(
        K, capacity, rate, signed):
    _check_argsort(spikes(RNG, (3, 4, K), rate, signed=signed), capacity)


@settings(max_examples=15, deadline=None)
@given(st.integers(1, 96), st.integers(1, 120), st.floats(0.0, 1.0),
       st.integers(0, 2**31 - 1))
def test_step_events_argsort_property(K, capacity, rate, seed):
    rng = np.random.default_rng(seed)
    _check_argsort(spikes(rng, (2, 3, K), rate, signed=True), capacity)


# ------------------------------------------------------ event_forward_aer
def _aer_case(sizes, T, B, rate, seed=3, threshold=0.3):
    ref_cfg = ref_snn.SNNConfig(layer_sizes=sizes, num_steps=T)
    ref_p, port_p = params_pair(ref_cfg, seed=seed)
    # a lower threshold so that hidden and output layers spike
    ref_p = {n: {**lp, "threshold": jnp.full_like(lp["threshold"], threshold)}
             for n, lp in ref_p.items()}
    for lp in port_p.values():
        lp["threshold"].fill_(threshold)
    dense = spikes(RNG, (T, B, sizes[0]), rate, signed=True)
    return ref_cfg, ref_p, port_p, dense


def _assert_forward_equal(got, ref):
    m, s, ev = got
    rm, rs, rev = (np.asarray(x) for x in ref)
    np.testing.assert_array_equal(s.numpy(), rs)
    np.testing.assert_array_equal(ev.numpy(), rev)
    np.testing.assert_allclose(m.numpy(), rm, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("sizes,T,B,rate", [
    ((100, 24, 2), 10, 3, 0.2),
    ((64, 32, 16, 2), 7, 2, 0.4),
    ((40, 12, 2), 5, 1, 0.0),  # a silent stream
])
def test_event_forward_aer_equals_reference(sizes, T, B, rate):
    ref_cfg, ref_p, port_p, dense = _aer_case(sizes, T, B, rate)
    ref_s, port_s = _streams(dense, T * sizes[0])
    got = runtime.event_forward_aer(port_p, port_s, port_cfg(ref_cfg))
    ref = ref_runtime.event_forward_aer(ref_p, ref_s, ref_cfg)
    _assert_forward_equal(got, ref)
    assert got[1].abs().sum() > 0 or rate == 0.0


def test_event_forward_aer_ignores_in_window_padding():
    """merge without num_steps stamps pads at max(times)+1, inside a longer
    window (tests/test_events.py:309-339): they are not billed."""
    N, T_enc = 40, 3
    ref_cfg, ref_p, port_p, _ = _aer_case((N, 12, 2), 10, 2, 0.0)
    a, b = _disjoint_pair(T_enc, 2, N, 0.3)
    ra, pa = _streams(a, T_enc * N)
    rb, pb = _streams(b, T_enc * N)
    merged = aer.merge(pa, pb, num_addrs=N, capacity=2 * T_enc * N)
    ref_merged = ref_aer.merge(ra, rb, num_addrs=N, capacity=2 * T_enc * N)
    assert int(merged.times.max()) < ref_cfg.num_steps  # pads in the window
    got = runtime.event_forward_aer(port_p, merged, port_cfg(ref_cfg))
    _assert_forward_equal(
        got, ref_runtime.event_forward_aer(ref_p, ref_merged, ref_cfg))
    np.testing.assert_array_equal(got[2][0].numpy(),
                                  merged.count.numpy().astype(np.float32))


def test_event_forward_aer_equals_event_forward_on_signed_planes():
    """The AER-direct path against the port's own dense-input path on
    ``input_planes(..., "signed")`` of the same stream."""
    ref_cfg, _, port_p, dense = _aer_case((80, 20, 2), 9, 3, 0.25)
    cfg = port_cfg(ref_cfg)
    _, stream = _streams(dense, 9 * 80)
    planes = aer.input_planes(stream, 9, 80, polarity_mode="signed")
    for backend in ("torch", "fused"):
        m, s, ev = runtime.event_forward(port_p, planes, cfg, backend=backend)
        am, asp, aev = runtime.event_forward_aer(port_p, stream, cfg)
        assert torch.equal(asp, s) and torch.equal(aev, ev)
        torch.testing.assert_close(am, m, atol=1e-5, rtol=1e-5)


def test_event_forward_aer_goes_through_the_aer_wrapper(monkeypatch):
    """Every layer of every step is one aer call: T x L a window."""
    ref_cfg, _, port_p, dense = _aer_case((48, 16, 8, 2), 6, 2, 0.3)
    _, stream = _streams(dense, 6 * 48)
    calls = []
    real = aer_matmul.aer_spike_matmul_batched

    def counted(a, v, w):
        calls.append((tuple(a.shape), a.dtype, v.dtype, tuple(w.shape)))
        return real(a, v, w)

    monkeypatch.setattr(aer_matmul, "aer_spike_matmul_batched", counted)
    runtime.event_forward_aer(port_p, stream, port_cfg(ref_cfg))
    assert len(calls) == 6 * 3
    widest = int((dense != 0).sum(-1).max())
    assert calls[0] == ((2, widest), torch.int32, torch.float32, (48, 16))
    assert calls[1] == ((2, 16), torch.int32, torch.float32, (16, 8))


def test_step_windows_pack_each_step_valid_first():
    T, N = 5, 12
    dense = spikes(RNG, (T, 3, N), 0.4, signed=True)
    _, stream = _streams(dense, T * N + 7)  # a padding tail
    addrs, values, counts = runtime.step_windows(stream, T)
    assert addrs.shape[:2] == (T, 3) and values.shape == addrs.shape
    np.testing.assert_array_equal(counts.numpy(), (dense != 0).sum(-1))
    back = np.zeros_like(dense)
    for s in range(T):
        for b in range(3):
            n = int(counts[s, b])
            assert (values[s, b, n:] == 0).all() and (addrs[s, b, n:] == 0).all()
            back[s, b, addrs[s, b, :n].numpy()] = values[s, b, :n].numpy()
    np.testing.assert_array_equal(back, dense)
