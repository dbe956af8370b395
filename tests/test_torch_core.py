"""Port parity: quantization, surrogates, neurons, coding, the dense SNN
forward and the energy model against the JAX reference."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import params_pair, port_cfg, spikes, t
from repro.core import coding as ref_coding
from repro.core import energy as ref_energy
from repro.core import neuron as ref_neuron
from repro.core import quant as ref_quant
from repro.core import snn as ref_snn
from repro.core import surrogate as ref_surrogate
from repro_torch.core import coding, energy, neuron, quant, snn, surrogate

RNG = np.random.default_rng(7)


def _values(n=4096):
    x = RNG.normal(0.0, 0.6, n).astype(np.float32)
    # exact half-way points exercise round-half-to-even, plus saturation
    ties = (np.arange(-8, 8) + 0.5).astype(np.float32) / 32768.0
    return np.concatenate([x, ties, np.float32([-1.5, 1.5, 1.0, -1.0])])


@pytest.mark.parametrize("fmt", ["Q1_15", "Q4_12", "Q8_8", "Q1_7"])
def test_quant_codes_and_fake_quant_bit_exact(fmt):
    x = _values()
    rf, pf = getattr(ref_quant, fmt), getattr(quant, fmt)
    codes = quant.quantize(t(x), pf)
    ref_codes = np.asarray(ref_quant.quantize(jnp.asarray(x), rf))
    assert codes.numpy().dtype == ref_codes.dtype
    np.testing.assert_array_equal(codes.numpy(), ref_codes)
    np.testing.assert_array_equal(
        quant.dequantize(codes, pf).numpy(),
        np.asarray(ref_quant.dequantize(jnp.asarray(ref_codes), rf)),
    )
    fq = quant.fake_quant(t(x), pf).numpy()
    ref_fq = np.asarray(ref_quant.fake_quant(jnp.asarray(x), rf))
    np.testing.assert_array_equal(fq.view(np.int32), ref_fq.view(np.int32))


def test_fake_quant_straight_through_gradient():
    # inside, outside and exactly on the clip bounds, where the gradient
    # splits 0.5/0.5 between the input and the bound
    x = _values(256)
    fmt = quant.Q1_15
    x = np.concatenate(
        [x, np.float32([fmt.min_val, fmt.max_val, fmt.min_val - 0.5,
                        fmt.max_val + 0.5])]
    ).astype(np.float32)
    assert (x == fmt.min_val).any() and (x == fmt.max_val).any()
    xt = t(x).requires_grad_(True)
    quant.fake_quant(xt).sum().backward()
    ref_g = jax.grad(lambda v: ref_quant.fake_quant(v).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(ref_g))


@pytest.mark.parametrize("name", ["atan", "fast_sigmoid", "boxcar"])
def test_surrogate_forward_exact_and_gradient(name):
    u = np.concatenate(
        [RNG.normal(0, 1, 512), [0.0, -0.0, 0.49, -0.5]]
    ).astype(np.float32)
    ut = t(u).requires_grad_(True)
    out = surrogate.get(name)(ut)
    ref_fn = ref_surrogate.get(name)
    np.testing.assert_array_equal(
        out.detach().numpy(), np.asarray(ref_fn(jnp.asarray(u)))
    )
    out.sum().backward()
    ref_g = jax.grad(lambda v: ref_fn(v).sum())(jnp.asarray(u))
    np.testing.assert_allclose(
        ut.grad.numpy(), np.asarray(ref_g), rtol=1e-6, atol=1e-7
    )


@pytest.mark.parametrize("kind", ["lif", "lapicque"])
@pytest.mark.parametrize("reset", ["zero", "subtract"])
@pytest.mark.parametrize("refractory", [0, 3])
def test_neuron_step_matches_reference(kind, reset, refractory):
    B, N, T = 4, 33, 12
    kw = dict(kind=kind, reset=reset, refractory_steps=refractory,
              lapicque_gain=0.7)
    ref_cfg, cfg = ref_neuron.NeuronConfig(**kw), neuron.NeuronConfig(**kw)
    cur = RNG.normal(0.4, 0.6, (T, B, N)).astype(np.float32)
    beta = RNG.uniform(0.5, 0.95, N).astype(np.float32)
    thr = RNG.uniform(0.5, 1.5, N).astype(np.float32)
    u0 = RNG.normal(0, 0.5, (B, N)).astype(np.float32)
    r0 = RNG.integers(0, 4, (B, N)).astype(np.int32)
    ref_st = ref_neuron.NeuronState(jnp.asarray(u0), jnp.asarray(r0))
    st = neuron.NeuronState(t(u0), t(r0))
    for step in range(T):
        ref_st, ref_spk = ref_neuron.neuron_step(
            ref_cfg, ref_st, jnp.asarray(cur[step]),
            beta=jnp.asarray(beta), threshold=jnp.asarray(thr),
        )
        st, spk = neuron.neuron_step(
            cfg, st, t(cur[step]), beta=t(beta), threshold=t(thr)
        )
        np.testing.assert_array_equal(spk.numpy(), np.asarray(ref_spk))
        np.testing.assert_array_equal(
            st.refrac.numpy(), np.asarray(ref_st.refrac)
        )
        np.testing.assert_allclose(
            st.u.numpy(), np.asarray(ref_st.u), atol=1e-5, rtol=1e-5
        )


def test_run_neuron_matches_reference():
    cfg_kw = dict(refractory_steps=2)
    cur = RNG.normal(0.5, 0.5, (10, 3, 16)).astype(np.float32)
    beta, thr = np.float32(0.8), np.float32(1.0)
    spk, fin = neuron.run_neuron(
        neuron.NeuronConfig(**cfg_kw), t(cur),
        beta=torch.tensor(beta), threshold=torch.tensor(thr),
    )
    ref_spk, ref_fin = ref_neuron.run_neuron(
        ref_neuron.NeuronConfig(**cfg_kw), jnp.asarray(cur),
        beta=beta, threshold=thr,
    )
    np.testing.assert_array_equal(spk.numpy(), np.asarray(ref_spk))
    np.testing.assert_array_equal(
        fin.refrac.numpy(), np.asarray(ref_fin.refrac)
    )
    np.testing.assert_allclose(
        fin.u.numpy(), np.asarray(ref_fin.u), atol=1e-5, rtol=1e-5
    )


@pytest.mark.parametrize("T", [1, 7, 25])
def test_deterministic_and_ttfs_coding_bit_exact(T):
    x = np.concatenate(
        [RNG.random(200), [0.0, 1.0, 0.5, -0.2, 1.3]]
    ).astype(np.float32).reshape(5, 41)
    np.testing.assert_array_equal(
        coding.rate_encode_deterministic(t(x), T).numpy(),
        np.asarray(ref_coding.rate_encode_deterministic(jnp.asarray(x), T)),
    )
    np.testing.assert_array_equal(
        coding.ttfs_encode(t(x), T).numpy(),
        np.asarray(ref_coding.ttfs_encode(jnp.asarray(x), T)),
    )


def test_rate_encode_is_bernoulli_at_the_pixel_rate():
    x = torch.tensor([0.0, 0.25, 1.0, 1.7])
    s = coding.rate_encode(torch.Generator().manual_seed(0), x, 4000)
    assert s.shape == (4000, 4) and s.dtype == torch.float32
    assert set(np.unique(s.numpy())) <= {0.0, 1.0}
    rates = s.mean(dim=0).numpy()
    assert rates[0] == 0.0 and rates[2] == 1.0 and rates[3] == 1.0
    assert abs(rates[1] - 0.25) < 0.03


@pytest.mark.parametrize("variant", ["lif", "refractory", "lapicque", "q115"])
def test_snn_forward_matches_reference(variant):
    kw = {
        "lif": {},
        "refractory": {"refractory_steps": 2},
        "lapicque": {"neuron_kind": "lapicque"},
        "q115": {"quant_q115": True},
    }[variant]
    ref_cfg = ref_snn.SNNConfig(layer_sizes=(48, 20, 2), num_steps=12, **kw)
    ref_p, port_p = params_pair(ref_cfg, seed=3)
    x = spikes(RNG, (12, 3, 48), 0.35)
    ref_mem, ref_spk = ref_snn.forward(ref_p, jnp.asarray(x), ref_cfg)
    mem, spk = snn.forward(port_p, t(x), port_cfg(ref_cfg))
    np.testing.assert_array_equal(spk.numpy(), np.asarray(ref_spk))
    np.testing.assert_allclose(
        mem.numpy(), np.asarray(ref_mem), atol=1e-5, rtol=1e-5
    )
    np.testing.assert_array_equal(
        snn.predict_from_traces(mem, spk).numpy(),
        np.asarray(ref_snn.predict_from_traces(ref_mem, ref_spk)),
    )


def test_params_from_numpy_keeps_layout_and_effective_beta():
    ref_cfg = ref_snn.SNNConfig(layer_sizes=(30, 8, 2))
    ref_p, port_p = params_pair(ref_cfg)
    for name, lp in ref_p.items():
        for k, v in lp.items():
            np.testing.assert_array_equal(port_p[name][k].numpy(), np.asarray(v))
        np.testing.assert_allclose(
            snn.effective_beta(port_p[name]).numpy(),
            np.asarray(ref_snn.effective_beta(lp)),
            rtol=1e-6,
        )


def test_init_params_shapes_and_bounds():
    cfg = snn.SNNConfig(layer_sizes=(64, 16, 2))
    p = snn.init_params(torch.Generator().manual_seed(0), cfg)
    assert p["layer0"]["w"].shape == (64, 16)
    assert p["layer1"]["b"].shape == (2,)
    assert float(p["layer0"]["w"].abs().max()) <= 1 / 8
    np.testing.assert_allclose(
        snn.effective_beta(p["layer1"]).numpy(), 0.9, rtol=1e-6
    )


@pytest.mark.parametrize("kind", ["lif", "lapicque"])
def test_energy_model_equal(kind):
    sizes, T = (4096, 512, 2), 25
    ev = [40123.0, 901.0]
    a = energy.snn_ops_from_events(sizes, T, ev, neuron_kind=kind)
    b = ref_energy.snn_ops_from_events(sizes, T, ev, neuron_kind=kind)
    assert a.ops == b.ops
    assert a.energy_pj() == b.energy_pj()
    assert a.gops_per_watt() == b.gops_per_watt()
    c = energy.snn_inference_ops(sizes, T, [0.3, 0.05])
    d = ref_energy.snn_inference_ops(sizes, T, [0.3, 0.05])
    assert c.ops == d.ops and c.total_ops() == d.total_ops()
