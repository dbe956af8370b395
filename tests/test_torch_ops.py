"""Port parity: the public kernel API (``repro_torch.kernels.ops``) and the
paper's Fig. 5 hardware path against the JAX reference (its Pallas
kernels in interpret mode and its ``kernels.ref`` oracles).  On the CPU
every wrapper runs its plain version; the card's tests hold the kernels
against those (``tests/test_torch_kernels_cuda.py``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _torch_parity import params_pair, port_cfg, spikes, t
from repro.core import coding as ref_coding
from repro.core import quant as ref_quant
from repro.core import snn as ref_snn
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro_torch.core import coding, quant, snn
from repro_torch.kernels import lif_fused as lif_mod
from repro_torch.kernels import ops, ref

RNG = np.random.default_rng(31)


def _codes(shape, rng=RNG):
    return rng.integers(-(2**15), 2**15, shape).astype(np.int16)


# ------------------------------------------------------------- lif_fused
@pytest.mark.parametrize("T,B,N", [(5, 3, 7), (8, 4, 130), (25, 2, 2)])
@pytest.mark.parametrize("refractory", [0, 5])
@pytest.mark.parametrize("reset", ["zero", "subtract"])
def test_lif_fused_matches_reference(T, B, N, refractory, reset):
    rng = np.random.default_rng(T * 1000 + N)
    cur = rng.normal(0.3, 0.7, (T, B, N)).astype(np.float32)
    beta = rng.uniform(0.5, 0.99, N).astype(np.float32)
    thr = rng.uniform(0.5, 1.5, N).astype(np.float32)
    before = ops.lif_fused.launches
    spk, u = ops.lif_fused(t(cur), t(beta), t(thr),
                           refractory_steps=refractory, reset=reset)
    assert ops.lif_fused.launches == before  # a CPU tensor launches nothing
    assert spk.dtype == u.dtype == torch.float32
    assert spk.any()
    args = (jnp.asarray(cur), jnp.asarray(beta), jnp.asarray(thr))
    kw = dict(refractory_steps=refractory, reset=reset)
    for r_spk, r_u in (ref_ops.lif_fused(*args, **kw),
                       ref_kernels.lif_fused_ref(*args, **kw)):
        np.testing.assert_array_equal(spk.numpy(), np.asarray(r_spk))
        np.testing.assert_allclose(u.numpy(), np.asarray(r_u),
                                   rtol=1e-5, atol=1e-5)


def test_lif_fused_rejects_unknown_reset():
    cur = torch.zeros(3, 2, 4)
    beta, thr = torch.full((4,), 0.9), torch.ones(4)
    for fn in (ops.lif_fused, ref.lif_fused_ref):
        with pytest.raises(ValueError, match="reset"):
            fn(cur, beta, thr, reset="hard")
    with pytest.raises(ValueError, match=r"\(4,\)"):
        ops.lif_fused(cur, beta[:3], thr)


# ---------------------------------------------------------- spike_matmul
@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (5, 300, 70), (37, 513, 129),
                                   (40, 256, 64)])
def test_spike_matmul_bit_exact(M, K, N):
    spk = (RNG.random((M, K)) < 0.15).astype(np.int8)
    spk[0] = 0  # a silent row
    wq = _codes((K, N))
    before = ops.spike_matmul.launches
    got = ops.spike_matmul(t(spk), t(wq))
    assert ops.spike_matmul.launches == before
    assert got.dtype == torch.int32
    sj, wj = jnp.asarray(spk), jnp.asarray(wq)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_ops.spike_matmul(sj, wj)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_kernels.spike_matmul_ref(sj, wj))
    )


def test_spike_matmul_zero_spikes_and_integer_values():
    wq = _codes((256, 32))
    zero = ops.spike_matmul(torch.zeros(16, 256, dtype=torch.int8), t(wq))
    assert not zero.any()
    # the contract is the integer product: a spike other than 0/1 multiplies
    spk = RNG.integers(-3, 4, (9, 256)).astype(np.int8)
    np.testing.assert_array_equal(
        ops.spike_matmul(t(spk), t(wq)).numpy(),
        np.asarray(ref_kernels.spike_matmul_ref(jnp.asarray(spk), jnp.asarray(wq))),
    )


def test_spike_matmul_fits_28bit_accumulator():
    spk = np.ones((2, 4096), np.int8)
    for code in (-(2**15), 2**15 - 1):
        wq = np.full((4096, 8), code, np.int16)
        got = ops.spike_matmul(t(spk), t(wq)).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(ref_ops.spike_matmul(jnp.asarray(spk), jnp.asarray(wq)))
        )
        assert np.all(got == code * 4096)
    assert quant.accumulator_bits(4096) == ref_quant.accumulator_bits(4096) == 28


def test_spike_matmul_sliced_product_is_exact(monkeypatch):
    """The plain version's K slices sum to the one-slice result."""
    from repro_torch.kernels import spike_matmul as smm

    spk = (RNG.random((6, 77)) < 0.5).astype(np.int8)
    wq = _codes((77, 5))
    whole = ops.spike_matmul(t(spk), t(wq))
    monkeypatch.setattr(smm, "CHUNK_ELEMS", 6 * 5 * 4)  # slices of 4 rows of K
    assert smm.k_chunk(6, 5) == 4
    assert torch.equal(ops.spike_matmul(t(spk), t(wq)), whole)


def test_matmul_wrappers_reject_wrong_types_and_shapes():
    s8, w16 = torch.zeros(4, 8, dtype=torch.int8), torch.zeros(8, 3, dtype=torch.int16)
    with pytest.raises(TypeError, match="int8"):
        ops.spike_matmul(s8.float(), w16)
    with pytest.raises(ValueError, match=r"\(K, N\)"):
        ops.spike_matmul(s8, w16[:7])
    with pytest.raises(TypeError, match="int16"):
        ops.q115_matmul(s8, w16)
    with pytest.raises(TypeError, match="int16"):
        ops.q115_matmul(w16.T.contiguous(), w16.int(), saturate=False)


# ------------------------------------------------------ aer_spike_matmul
@pytest.mark.parametrize("rate", [0.0, 0.25, 1.0])
@pytest.mark.parametrize("K,N", [(64, 32), (257, 129)])
def test_aer_spike_matmul_matches_reference_and_dense(rate, K, N):
    wq = _codes((K, N))
    row = (RNG.random(K) < rate).astype(np.int8)
    idx = np.nonzero(row)[0]
    E = K + 5  # capacity with a padding tail
    addrs = np.zeros(E, np.int32)
    values = np.zeros(E, np.int32)
    addrs[: len(idx)] = idx
    values[: len(idx)] = 1
    before = ops.aer_spike_matmul.launches
    got = ops.aer_spike_matmul(t(addrs), t(values), t(wq))
    assert ops.aer_spike_matmul.launches == before
    assert got.dtype == torch.int32 and got.shape == (N,)
    aj, vj, wj = jnp.asarray(addrs), jnp.asarray(values), jnp.asarray(wq)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref_ops.aer_spike_matmul(aj, vj, wj)))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_kernels.aer_spike_matmul_ref(aj, vj, wj))
    )
    dense = ops.spike_matmul(t(row[None]), t(wq))[0]
    assert torch.equal(got, dense)


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.int64])
def test_aer_spike_matmul_polarity_and_value_types(dtype):
    K, N = 50, 20
    wq = _codes((K, N))
    addrs = np.int32([3, 3, 10, 0, 7, 7, 7])
    values = np.array([1, -1, 1, 0, 2, -3, 1], dtype)  # cancel, pad, weights
    got = ops.aer_spike_matmul(t(addrs), t(values), t(wq))
    want = ref_kernels.aer_spike_matmul_ref(
        jnp.asarray(addrs), jnp.asarray(values.astype(np.int32)), jnp.asarray(wq)
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), wq[10].astype(np.int32))


def test_aer_spike_matmul_rejects_what_it_cannot_take():
    a, v, w = torch.zeros(4, dtype=torch.int32), torch.ones(4, dtype=torch.int32), torch.zeros(8, 3, dtype=torch.int16)
    with pytest.raises(TypeError, match="integer"):
        ops.aer_spike_matmul(a, v.float(), w)
    with pytest.raises(TypeError, match="int16"):
        ops.aer_spike_matmul(a, v, w.float())
    with pytest.raises(TypeError, match="int32"):
        ops.aer_spike_matmul(a.long(), v, w)
    with pytest.raises(ValueError, match=r"\(E,\)"):
        ops.aer_spike_matmul(a[None], v[None], w)


# ----------------------------------------------------------- q115_matmul
@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (33, 129, 65), (16, 4096, 8)])
@pytest.mark.parametrize("saturate", [True, False])
def test_q115_matmul_bit_exact(M, K, N, saturate):
    xq, wq = _codes((M, K)), _codes((K, N))
    xq[0, :] = -(2**15)  # the extreme code, whose square is 2^30
    wq[:, 0] = -(2**15)
    before = ops.q115_matmul.launches
    got = ops.q115_matmul(t(xq), t(wq), saturate=saturate)
    assert ops.q115_matmul.launches == before
    assert got.dtype == (torch.int16 if saturate else torch.int32)
    xj, wj = jnp.asarray(xq), jnp.asarray(wq)
    want = (ref_kernels.q115_matmul_ref if saturate
            else ref_kernels.q115_matmul_acc_ref)(xj, wj)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_ops.q115_matmul(xj, wj, saturate=saturate))
    )
    plain = ref.q115_matmul_ref if saturate else ref.q115_matmul_acc_ref
    assert torch.equal(plain(t(xq), t(wq)), got)


# ----------------------------------------------------- snn_layer_forward
@pytest.mark.parametrize("refractory", [0, 5])
def test_snn_layer_forward_matches_reference(refractory):
    rcfg = ref_snn.SNNConfig(layer_sizes=(256, 64, 2), num_steps=10)
    ref_params, params = params_pair(rcfg, seed=13)
    for p in (ref_params["layer1"], params["layer1"]):
        p["threshold"] = p["threshold"] * 0 + 0.05  # let the output layer fire
    x = spikes(np.random.default_rng(refractory), (10, 4, 256), 0.4)
    h, r = t(x), jnp.asarray(x)
    for i in range(2):
        lp, rp = params[f"layer{i}"], ref_params[f"layer{i}"]
        h = ops.snn_layer_forward(h, lp["w"], lp["b"], snn.effective_beta(lp),
                                  lp["threshold"], refractory_steps=refractory)
        r = ref_ops.snn_layer_forward(r, rp["w"], rp["b"],
                                      ref_snn.effective_beta(rp),
                                      rp["threshold"],
                                      refractory_steps=refractory)
        assert h.shape == (10, 4, (64, 2)[i]) and h.dtype == torch.float32
        np.testing.assert_array_equal(h.numpy(), np.asarray(r))
        assert h.any()


def _wrap_layer():
    """A layer whose adder tree reaches +-2^31 - 2 at (t, b) = (0, 0): 516
    spikes of 127 and one of 6 (the int8 spike multiplies) on weight codes
    +-32767, so the int32 bias add wraps (codes 32767 and -32768); a column
    of code 1000 whose sum 65,538,001 passes 2^24 and rounds to nearest
    even in the conversion; other rows are binary spike trains."""
    rng = np.random.default_rng(41)
    T, B, K, N = 3, 2, 517, 5
    x = (rng.random((T, B, K)) < 0.3).astype(np.float32)
    x[0, 0, :516], x[0, 0, 516] = 127.0, 6.0
    w = rng.uniform(-0.01, 0.01, (K, N)).astype(np.float32)
    w[:, 0], w[:, 1], w[:, 2] = 32767 / 32768, 1000 / 32768, -32767 / 32768
    b = np.float32([32767, 1, -32768, 300, -500]) / np.float32(32768)
    beta = rng.uniform(0.6, 0.95, N).astype(np.float32)
    thr = rng.uniform(0.4, 1.1, N).astype(np.float32)
    return x, w, b, beta, thr


@pytest.mark.parametrize("refractory", [0, 5])
def test_lif_fused_from_acc_matches_reference_at_the_wrap(refractory):
    """The int32 form of the LIF kernel's plain version, held against the
    reference's hardware path (Pallas in interpret mode): spikes exact
    through ``snn_layer_forward``, and spikes exact and membranes within
    1e-5 from the adder tree's sums, where the bias add wraps and the
    conversion rounds."""
    x, w, b, beta, thr = _wrap_layer()
    T, B, K = x.shape
    got = ops.snn_layer_forward(t(x), t(w), t(b), t(beta), t(thr),
                                refractory_steps=refractory)
    want = ref_ops.snn_layer_forward(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b), jnp.asarray(beta),
                                     jnp.asarray(thr),
                                     refractory_steps=refractory)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 0, 2] == 1 and got[0, 0, 0] == 0  # the wrapped sums

    wq = np.asarray(ref_quant.quantize(jnp.asarray(w), ref_quant.Q1_15))
    bq = np.asarray(ref_quant.quantize(jnp.asarray(b), ref_quant.Q1_15)).astype(np.int32)
    acc = np.asarray(ref_ops.spike_matmul(
        jnp.asarray(x.reshape(T * B, K).astype(np.int8)), jnp.asarray(wq)))
    assert acc[0, 0] == 2**31 - 2 and acc[0, 2] == -(2**31) + 2
    assert acc[0, 1] + bq[1] == 65_538_001
    cur = (jnp.asarray(acc) + jnp.asarray(bq)[None]).astype(jnp.float32)
    cur = (cur / ref_quant.Q1_15.scale).reshape(T, B, -1)
    r_spk, r_u = ref_ops.lif_fused(cur, jnp.asarray(beta), jnp.asarray(thr),
                                   refractory_steps=refractory)
    spk, u = lif_mod.lif_fused_from_acc(
        t(acc.reshape(T, B, -1)), t(bq), t(beta), t(thr),
        refractory_steps=refractory)
    assert float(np.asarray(cur)[0, 0, 1]) == 65_538_000 / 32768
    np.testing.assert_array_equal(spk.numpy(), np.asarray(r_spk))
    np.testing.assert_allclose(u.numpy(), np.asarray(r_u), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reset", ["zero", "subtract"])
def test_lif_fused_from_acc_plain_version_is_the_three_ops(reset):
    """On the CPU the int32 form runs its plain version: the int32 bias add
    (wrapping), the conversion and the divide by 2^15, then
    ``lif_fused_ref``; it launches nothing."""
    rng = np.random.default_rng(7)
    acc = rng.integers(-(2**31), 2**31, (6, 3, 9), dtype=np.int64).astype(np.int32)
    bias = rng.integers(-(2**15), 2**15, 9).astype(np.int32)
    acc[0, 0, 0], bias[0] = 2**31 - 1, 5
    beta = rng.uniform(0.5, 0.99, 9).astype(np.float32)
    thr = rng.uniform(0.5, 1.5, 9).astype(np.float32)
    kw = dict(refractory_steps=3, reset=reset)
    before = ops.lif_fused.launches
    spk, u = lif_mod.lif_fused_from_acc(t(acc), t(bias), t(beta), t(thr), **kw)
    assert ops.lif_fused.launches == before
    cur = (t(acc) + t(bias)[None, None]).to(torch.float32) / 2**15
    # the add wrapped to -2^31 + 4, which float32 rounds to -2^31
    assert float(cur[0, 0, 0]) == -65536.0
    r_spk, r_u = ref.lif_fused_ref(cur, t(beta), t(thr), **kw)
    assert torch.equal(spk, r_spk) and torch.equal(u, r_u)


def test_snn_layer_forward_feeds_the_lif_kernel_the_adder_tree_sums(monkeypatch):
    """A layer is spike_matmul and one LIF launch: the int32 sums go
    straight to ``lif_fused_from_acc`` with the int32 bias codes, and no
    float currents are made between them."""
    seen = []

    def record(acc, bias_q, beta, threshold, **kw):
        seen.append((acc.dtype, tuple(acc.shape), bias_q.dtype))
        return lif_mod.lif_fused_from_acc_ref(acc, bias_q, beta, threshold, **kw)

    def no_float_form(*args, **kw):
        raise AssertionError("the float LIF form ran in snn_layer_forward")

    monkeypatch.setattr(ops, "lif_fused_from_acc", record)
    monkeypatch.setattr(ops, "lif_fused", no_float_form)
    x, w, b, beta, thr = _wrap_layer()
    out = ops.snn_layer_forward(t(x), t(w), t(b), t(beta), t(thr))
    assert seen == [(torch.int32, (3, 2, 5), torch.int32)]
    assert out.shape == (3, 2, 5)


def test_snn_layer_forward_equals_fake_quant_float_graph():
    """The Fig. 5 pipeline equals the float graph with fake-quantized
    weights (the reference's own check of its hardware path)."""
    T, B, K, N = 9, 3, 200, 40
    rng = np.random.default_rng(4)
    w = t(rng.uniform(-0.05, 0.05, (K, N)).astype(np.float32))
    b = t(rng.uniform(-0.02, 0.02, N).astype(np.float32))
    beta = t(rng.uniform(0.6, 0.95, N).astype(np.float32))
    thr = t(rng.uniform(0.4, 1.1, N).astype(np.float32))
    x = t((rng.random((T, B, K)) < 0.2).astype(np.float32))
    out = ops.snn_layer_forward(x, w, b, beta, thr)
    cur = x @ quant.fake_quant(w) + quant.fake_quant(b)
    want, _ = ref.lif_fused_ref(cur, beta, thr)
    assert torch.equal(out, want)


# ------------------------------------------------------- core additions
def test_hidden_spike_rates_match_reference():
    rcfg = ref_snn.SNNConfig(layer_sizes=(64, 32, 2), num_steps=12)
    ref_params, params = params_pair(rcfg, seed=3)
    x = spikes(np.random.default_rng(8), (12, 5, 64), 0.5)
    got = snn.hidden_spike_rates(params, t(x), port_cfg(rcfg))
    want = ref_snn.hidden_spike_rates(ref_params, jnp.asarray(x), rcfg)
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert got[0] > 0


def test_spike_rate_and_quant_params_match_reference():
    x = spikes(np.random.default_rng(2), (7, 3, 11), 0.4)
    np.testing.assert_allclose(
        coding.spike_rate(t(x)).numpy(),
        np.asarray(ref_coding.spike_rate(jnp.asarray(x))), rtol=0, atol=1e-7,
    )
    rcfg = ref_snn.SNNConfig(layer_sizes=(16, 8, 2))
    ref_params, params = params_pair(rcfg, seed=4)
    params["layer0"]["count"] = torch.arange(3, dtype=torch.int32)
    for fmt in ("Q1_15", "Q1_7"):
        got = quant.quant_params(params, getattr(quant, fmt))
        want = ref_quant.quant_params(ref_params, getattr(ref_quant, fmt))
        for name, lp in want.items():
            for k, v in lp.items():
                np.testing.assert_array_equal(got[name][k].numpy(), np.asarray(v))
        assert torch.equal(got["layer0"]["count"], params["layer0"]["count"])
    for fan_in in (1, 2, 3, 512, 4097):
        assert quant.accumulator_bits(fan_in) == ref_quant.accumulator_bits(fan_in)


def test_predict_is_rate_coded_forward():
    rcfg = ref_snn.SNNConfig(layer_sizes=(64, 16, 2), num_steps=6)
    _, params = params_pair(rcfg, seed=6)
    cfg = port_cfg(rcfg)
    images = t(np.random.default_rng(9).random((5, 8, 8)).astype(np.float32))
    pred = snn.predict(params, images, cfg, torch.Generator().manual_seed(1))
    x = coding.rate_encode(torch.Generator().manual_seed(1), images.reshape(5, -1), 6)
    want = snn.predict_from_traces(*snn.forward(params, x, cfg))
    assert pred.shape == (5,) and torch.equal(pred, want)


def test_ops_exports_the_reference_api():
    for name in ("lif_fused", "spike_matmul", "aer_spike_matmul",
                 "aer_spike_matmul_batched", "snn_chunk", "q115_matmul",
                 "snn_layer_forward"):
        assert callable(getattr(ops, name)) and hasattr(ref_ops, name)
    for name in ("lif_fused_ref", "spike_matmul_ref", "aer_spike_matmul_ref",
                 "q115_matmul_ref", "q115_matmul_acc_ref"):
        assert callable(getattr(ref, name)) and hasattr(ref_kernels, name)
