"""The port's ``core.neuron.membrane_trace`` against the reference's: the
same seeded currents through both, spikes exact and the membrane
potential after each step within 1e-5, for both reset modes, with and
without a refractory period, and a Lapicque neuron."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import neuron as ref_neuron
from repro_torch.core import neuron


@pytest.mark.parametrize("reset", ["zero", "subtract"])
@pytest.mark.parametrize("kind,refractory", [("lif", 0), ("lif", 3),
                                             ("lapicque", 0)])
def test_membrane_trace_matches_reference(reset, kind, refractory):
    rng = np.random.default_rng(7)
    cur = rng.normal(0.6, 0.7, (12, 3, 16)).astype(np.float32)
    beta = rng.uniform(0.5, 0.95, (16,)).astype(np.float32)
    thr = rng.uniform(0.8, 1.2, (16,)).astype(np.float32)
    kw = dict(kind=kind, reset=reset, refractory_steps=refractory)
    spk, u = neuron.membrane_trace(
        neuron.NeuronConfig(**kw), torch.from_numpy(cur),
        beta=torch.from_numpy(beta), threshold=torch.from_numpy(thr))
    ref_spk, ref_u = ref_neuron.membrane_trace(
        ref_neuron.NeuronConfig(**kw), jnp.asarray(cur),
        beta=jnp.asarray(beta), threshold=jnp.asarray(thr))
    assert spk.shape == u.shape == cur.shape
    assert 0 < float(spk.sum()) < spk.numel()  # some steps fire, some not
    np.testing.assert_array_equal(spk.numpy(), np.asarray(ref_spk))
    np.testing.assert_allclose(u.numpy(), np.asarray(ref_u), atol=1e-5,
                               rtol=1e-5)


def test_membrane_trace_ends_where_run_neuron_does():
    rng = np.random.default_rng(8)
    cur = torch.from_numpy(rng.normal(0.5, 0.5, (9, 4, 8)).astype(np.float32))
    cfg = neuron.NeuronConfig(refractory_steps=2)
    beta, thr = torch.tensor(0.8), torch.tensor(1.0)
    spk, u = neuron.membrane_trace(cfg, cur, beta=beta, threshold=thr)
    run_spk, final = neuron.run_neuron(cfg, cur, beta=beta, threshold=thr)
    assert torch.equal(spk, run_spk)
    assert torch.equal(u[-1], final.u)
