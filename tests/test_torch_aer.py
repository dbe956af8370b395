"""Port parity: the ``aer_spike_matmul_batched`` plain version, delta
coding, AER streams, polarity planes and the synthetic DVS camera against
the JAX reference (its Pallas kernel in interpret mode)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import t
from repro.core import coding as ref_coding
from repro.events import aer as ref_aer
from repro.kernels import aer_matmul as ref_aer_mm
from repro.kernels import ref as ref_kernels
from repro_torch.core import coding
from repro_torch.events import aer
from repro_torch.kernels import aer_matmul

RNG = np.random.default_rng(23)


def _tables(B, E, K, rate, counts=None):
    """Valid-first (B, E) event tables: distinct ascending addresses, signed
    values, ragged counts, padding at address 0 with value 0."""
    a = np.zeros((B, E), np.int32)
    v = np.zeros((B, E), np.float32)
    for b in range(B):
        n = counts[b] if counts is not None else int(RNG.binomial(min(E, K), rate))
        a[b, :n] = np.sort(RNG.choice(K, n, replace=False))
        v[b, :n] = RNG.choice(np.float32([-1.0, 1.0]), n)
    return a, v


# (B, E, K, N, rate, counts): ragged counts, an empty stream, a full one,
# N not a multiple of the 128-column block, E not a multiple of the
# 128-event block
CASES = [
    (3, 300, 300, 200, 0.3, [0, 300, 57]),
    (4, 64, 96, 130, 0.5, None),
    (2, 130, 130, 2, 0.9, [130, 1]),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_aer_matmul_int16_bit_exact(case):
    B, E, K, N, rate, counts = CASES[case]
    a, v = _tables(B, E, K, rate, counts)
    v[0, :3] = 0.0  # zero values inside the valid run
    w = RNG.integers(-32768, 32768, (K, N)).astype(np.int16)
    got = aer_matmul.aer_spike_matmul_batched(
        t(a), t(v.astype(np.int8)), t(w)
    )
    assert got.dtype == torch.int32
    ref = ref_aer_mm.aer_spike_matmul_batched(
        jnp.asarray(a), jnp.asarray(v.astype(np.int32)), jnp.asarray(w),
        interpret=True,
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for b in range(B):  # the reference's per-stream integer contract
        np.testing.assert_array_equal(
            got[b].numpy(),
            np.asarray(ref_kernels.aer_spike_matmul_ref(
                jnp.asarray(a[b]), jnp.asarray(v[b].astype(np.int32)),
                jnp.asarray(w))),
        )


@pytest.mark.parametrize("case", range(len(CASES)))
def test_aer_matmul_float32_matches_reference(case):
    B, E, K, N, rate, counts = CASES[case]
    a, v = _tables(B, E, K, rate, counts)
    v *= RNG.uniform(0.2, 1.5, v.shape).astype(np.float32)
    w = RNG.normal(0, 0.1, (K, N)).astype(np.float32)
    got = aer_matmul.aer_spike_matmul_batched(t(a), t(v), t(w))
    ref = ref_aer_mm.aer_spike_matmul_batched(
        jnp.asarray(a), jnp.asarray(v), jnp.asarray(w), interpret=True
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_aer_matmul_plain_version_adds_in_event_order_and_skips_bad_events():
    B, E, K, N = 2, 9, 6, 5
    a = np.array([[0, 5, 6, -1, 2, 2, 0, 0, 0],
                  [3, 1, 100, 4, 0, 0, 0, 0, 0]], np.int32)
    v = np.float32([[0.5, -1, 1, 1, 0.25, 1, 0, 0, 0],
                    [1, 1, 1, -2, 0, 0, 0, 0, 0]])
    w = RNG.normal(0, 1, (K, N)).astype(np.float32)
    got = aer_matmul.aer_spike_matmul_batched_ref(t(a), t(v), t(w)).numpy()
    want = np.zeros((B, N), np.float32)
    for b in range(B):
        for e in range(E):
            if v[b, e] != 0 and 0 <= a[b, e] < K:  # live events, in order
                want[b] = want[b] + np.float32(v[b, e]) * w[a[b, e]]
    np.testing.assert_array_equal(got, want)


def test_aer_matmul_contract_holds_on_finite_weights_only():
    """Finite weights are part of the AER contract, as addresses in range
    are.  A padding slot (value 0) points at row 0; with W[0] = inf the
    reference's Pallas kernel adds 0 * inf = NaN for every padding slot of
    an E block that holds a live event and skips a block that holds none,
    so its answer depends on ``block_e``, a TPU tiling parameter; the port
    adds live events only.  On finite weights all of them agree."""
    a = np.array([[1, 0, 0, 0]], np.int32)
    v = np.array([[1, 0, 0, 0]], np.float32)
    w = np.array([[np.inf, 1], [2, 3], [4, 5]], np.float32)

    def pallas(weights, block_e):
        return np.asarray(ref_aer_mm.aer_spike_matmul_batched(
            jnp.asarray(a), jnp.asarray(v), jnp.asarray(weights),
            block_e=block_e, interpret=True))

    for block_e in (2, 4):
        np.testing.assert_array_equal(pallas(w, block_e), [[np.nan, 3]])
    np.testing.assert_array_equal(pallas(w, 1), [[2, 3]])
    port = aer_matmul.aer_spike_matmul_batched(t(a), t(v), t(w))
    np.testing.assert_array_equal(port.numpy(), [[2, 3]])
    finite = w.copy()
    finite[0, 0] = 7.0
    for block_e in (1, 2, 4):
        np.testing.assert_array_equal(pallas(finite, block_e), [[2, 3]])
    np.testing.assert_array_equal(
        aer_matmul.aer_spike_matmul_batched(t(a), t(v), t(finite)).numpy(),
        [[2, 3]])


def test_aer_matmul_runs_the_plain_version_on_cpu_and_checks_inputs():
    a, v = _tables(2, 8, 8, 0.5)
    w = RNG.normal(0, 1, (8, 3)).astype(np.float32)
    before = aer_matmul.aer_spike_matmul_batched.launches
    out = aer_matmul.aer_spike_matmul_batched(t(a), t(v), t(w))
    assert aer_matmul.aer_spike_matmul_batched.launches == before
    assert torch.equal(out, aer_matmul.aer_spike_matmul_batched_ref(t(a), t(v), t(w)))
    with pytest.raises(TypeError, match="int32"):
        aer_matmul.aer_spike_matmul_batched(t(a).long(), t(v), t(w))
    with pytest.raises(TypeError, match="float32 values"):
        aer_matmul.aer_spike_matmul_batched(t(a), t(v).double(), t(w))
    with pytest.raises(TypeError, match="int8/int16/int32"):
        aer_matmul.aer_spike_matmul_batched(t(a), t(v), t(w).to(torch.int16))
    with pytest.raises(TypeError, match="int16 or float32"):
        aer_matmul.aer_spike_matmul_batched(t(a), t(v), t(w).double())
    with pytest.raises(ValueError, match="values"):
        aer_matmul.aer_spike_matmul_batched(t(a), t(v)[:, :4], t(w))


def test_delta_encode_exact():
    x = RNG.uniform(0, 1, (12, 3, 17)).astype(np.float32)
    x[5:] = x[4]  # a still stretch
    got = coding.delta_encode(t(x), threshold=0.1)
    ref = ref_coding.delta_encode(jnp.asarray(x), threshold=0.1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("capacity", [5, 40, 200])
def test_dense_to_aer_and_back_exact(capacity):
    s = (RNG.random((6, 2, 3, 11)) < 0.3).astype(np.float32)
    s *= RNG.choice(np.float32([-1.0, 1.0]), s.shape)
    got = aer.dense_to_aer(t(s), capacity)
    ref = ref_aer.dense_to_aer(jnp.asarray(s), capacity)
    for g, r in zip(got, ref):
        assert g.numpy().dtype == np.asarray(r).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    np.testing.assert_array_equal(
        aer.aer_to_dense(got, 6, 11).numpy(),
        np.asarray(ref_aer.aer_to_dense(ref, 6, 11)),
    )


@pytest.mark.parametrize("mode", ["two_channel", "signed", "on_only"])
def test_input_planes_exact(mode):
    s = (RNG.random((5, 3, 20)) < 0.4).astype(np.float32)
    s *= RNG.choice(np.float32([-1.0, 1.0]), s.shape)
    ref_stream = ref_aer.dense_to_aer(jnp.asarray(s), 80)
    # coincident ON+OFF events at one (step, pixel), as after a merge
    co = ref_aer.EventStream(
        times=jnp.asarray([[1, 1, 2]], jnp.int32),
        addrs=jnp.asarray([[2, 2, 4]], jnp.int32),
        polarity=jnp.asarray([[1, -1, 1]], jnp.int8),
        count=jnp.asarray([3], jnp.int32),
    )
    for stream, T, K in ((ref_stream, 5, 20), (co, 3, 5)):
        port = aer.EventStream(*(t(x) for x in stream))
        got = aer.input_planes(port, T, K, polarity_mode=mode)
        ref = ref_aer.input_planes(stream, T, K, polarity_mode=mode)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert aer.input_size_for(64, mode) == ref_aer.input_size_for(64, mode)
    with pytest.raises(ValueError, match="polarity mode"):
        aer.input_planes(port, 3, 5, polarity_mode="nope")


def _reference_draws(key, batch, hw):
    """The reference's per-recording draws, recreated from its keys."""
    label, cy, cx_c, x0, scenes = [], [], [], [], []
    for k in jax.random.split(key, batch):
        k_label, k_scene = jax.random.split(k)
        k1, k2, k3 = jax.random.split(k_scene, 3)
        label.append(int(jax.random.bernoulli(k_label, 0.5)))
        cy.append(float(hw * jax.random.uniform(k1, minval=0.5, maxval=0.7)))
        cx_c.append(float(hw * (0.5 + 0.2 * (jax.random.uniform(k2) - 0.5))))
        x0.append(float(hw * jax.random.uniform(k3, minval=0.05, maxval=0.25)))
        scenes.append(k_scene)
    draws = aer.DVSDraws(
        label=torch.tensor(label),
        cy=torch.tensor(cy, dtype=torch.float32),
        cx_c=torch.tensor(cx_c, dtype=torch.float32),
        x0=torch.tensor(x0, dtype=torch.float32),
    )
    return draws, scenes


def test_dvs_camera_fed_reference_draws_matches_reference():
    hw, T, B, cap, K = 12, 7, 5, 500, 144
    key = jax.random.PRNGKey(3)
    draws, scenes = _reference_draws(key, B, hw)
    frames = aer._render_frames(draws, hw, T)
    for b in range(B):
        ref_frames = ref_aer._render_frames(scenes[b], hw, T, int(draws.label[b]))
        np.testing.assert_allclose(frames[b].numpy(), np.asarray(ref_frames),
                                   atol=1e-6, rtol=0)
    assert set(draws.label.tolist()) == {0, 1}
    stream, labels = aer.dvs_collision_stream(
        draws, image_hw=hw, num_steps=T, capacity=cap
    )
    ref_stream, ref_labels = ref_aer.dvs_collision_batch(
        key, B, image_hw=hw, num_steps=T, capacity=cap
    )
    np.testing.assert_array_equal(labels.numpy(), np.asarray(ref_labels))
    for mode in ("signed", "two_channel"):
        np.testing.assert_array_equal(
            aer.input_planes(stream, T, K, polarity_mode=mode).numpy(),
            np.asarray(ref_aer.input_planes(ref_stream, T, K, polarity_mode=mode)),
        )


def test_dvs_batch_is_a_function_of_the_generator_seed():
    def batch(seed):
        gen = torch.Generator().manual_seed(seed)
        return aer.dvs_collision_batch(gen, 4, image_hw=8, num_steps=5,
                                       capacity=400)

    (s1, l1), (s2, l2), (s3, _) = batch(1), batch(1), batch(2)
    assert all(torch.equal(x, y) for x, y in zip(s1, s2)) and torch.equal(l1, l2)
    assert not torch.equal(s1.addrs, s3.addrs)
    assert int(s1.count.min()) > 64  # frame 0 spikes every pixel
