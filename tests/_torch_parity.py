"""Shared inputs for the PyTorch port's parity tests: made once with numpy
from a seed and handed to both the JAX reference and the port."""

import numpy as np
import torch

import jax

from repro.core import snn as ref_snn
from repro_torch.core import snn as port_snn


def np_tree(tree):
    """A params pytree of the reference as nested dicts of numpy arrays."""
    return {
        name: {k: np.asarray(v) for k, v in lp.items()}
        for name, lp in tree.items()
    }


def params_pair(ref_cfg, seed=5):
    """(reference params, port params on the CPU) with equal values."""
    ref = ref_snn.init_params(jax.random.PRNGKey(seed), ref_cfg)
    return ref, port_snn.params_from_numpy(np_tree(ref), "cpu")


def port_cfg(ref_cfg):
    """The port's SNNConfig with the reference config's fields."""
    import dataclasses

    return port_snn.SNNConfig(**dataclasses.asdict(ref_cfg))


def spikes(rng, shape, rate, signed=False):
    s = (rng.random(shape) < rate).astype(np.float32)
    if signed:
        s *= rng.choice(np.float32([-1.0, 1.0]), shape)
    return s


def t(x):
    """numpy -> CPU tensor (a copy)."""
    return torch.as_tensor(np.array(x))
