"""The params' logical axes and the abstract decode cache of the port's
LM zoo (``Model.logical_axes``, ``Model.abstract_cache``) against the
reference's ``Model(cfg).abstract()[1]`` and ``shapes.abstract_cache``,
name for name, at the ten archs' full widths."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.launch import shapes as ref_shp
from repro.models.model import Model as RefModel
from repro_torch import configs
from repro_torch.distributed.partitioning import _is_axes
from repro_torch.models.model import Model
from repro_torch.tree import tree_flatten_with_names


def _flat_axes(axes, prefix=""):
    """{'/'-joined name: axes tuple} of an axes tree of nested dicts."""
    if _is_axes(axes):
        return {prefix: axes}
    out = {}
    for k, v in axes.items():
        out.update(_flat_axes(v, f"{prefix}/{k}" if prefix else k))
    return out


def _flat_ref(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in leaves}


def _cfgs(arch, quant):
    ref, port = ref_configs.get(arch), configs.get(arch)
    if quant:
        ref = dataclasses.replace(ref, quant=quant)
        port = dataclasses.replace(port, quant=quant)
    return ref, port


@pytest.mark.parametrize("quant", [None, "q115_int", "q1_7_int"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_logical_axes_match_the_reference(arch, quant):
    ref_cfg, cfg = _cfgs(arch, quant)
    ref_params, ref_axes = RefModel(ref_cfg).abstract()
    axes = _flat_axes(Model(cfg).logical_axes())
    assert axes == _flat_axes(ref_axes)
    # one axis name per dim of the param it names, same structure
    names, leaves = tree_flatten_with_names(Model(cfg).abstract())
    assert sorted(names) == sorted(axes)
    ref_leaves = _flat_ref(ref_params)
    for n, t in zip(names, leaves):
        assert len(axes[n]) == t.ndim, n
        assert tuple(t.shape) == tuple(ref_leaves[n].shape), n
        assert str(t.dtype).replace("torch.", "") == str(ref_leaves[n].dtype), n


@pytest.mark.parametrize("shape", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_abstract_cache_matches_the_reference(arch, shape):
    sp = ref_shp.SHAPES[shape]
    ref = _flat_ref(RefModel(ref_configs.get(arch)).abstract_cache(
        sp.global_batch, sp.seq_len))
    names, leaves = tree_flatten_with_names(
        Model(configs.get(arch)).abstract_cache(sp.global_batch, sp.seq_len))
    assert sorted(names) == sorted(ref)
    for n, t in zip(names, leaves):
        assert t.device.type == "meta", n
        assert tuple(t.shape) == tuple(ref[n].shape), n
        assert str(t.dtype).replace("torch.", "") == str(ref[n].dtype), n


def test_init_and_abstract_return_the_params_alone():
    cfg = configs.get("recurrentgemma-2b").reduced()
    params = Model(cfg).init(0, device="cpu")
    abstract = Model(cfg).abstract()
    for tree in (params, abstract):
        assert isinstance(tree, dict)
        names, leaves = tree_flatten_with_names(tree)
        assert leaves and all(isinstance(t, torch.Tensor) for t in leaves)
    assert (tree_flatten_with_names(params)[0]
            == tree_flatten_with_names(abstract)[0])
    # the axes mode draws nothing: the generator's stream is unmoved
    gen = torch.Generator().manual_seed(3)
    want = torch.rand(4, generator=gen)
    gen.manual_seed(3)
    Model(cfg).logical_axes()
    assert torch.equal(torch.rand(4, generator=gen), want)


def test_init_draws_are_unchanged_by_the_axes_names():
    """The derived leaves (``A_log``, ``dt_bias``, ``lambda_raw``) are the
    functions of their draws they were: log of U[1, 16), the inverse
    softplus of U[1e-3, 1e-1), and the RG-LRU's a^c in [0.9, 0.999]."""
    for arch in ("mamba2-130m", "recurrentgemma-2b"):
        cfg = configs.get(arch).reduced()
        p = Model(cfg).init(0, device="cpu")
        names, leaves = tree_flatten_with_names(p)
        got = dict(zip(names, leaves))
        for n, t in got.items():
            leaf = n.split("/")[-1]
            if leaf == "A_log":
                a = np.exp(t.double().numpy())
                assert (a >= 1.0).all() and (a < 16.0 + 1e-3).all()
            elif leaf == "dt_bias":
                dt = np.log1p(np.exp(t.double().numpy()))
                assert (dt > 9e-4).all() and (dt < 0.1 + 1e-4).all()
            elif leaf == "lambda_raw":
                softplus = np.log1p(np.exp(t.double().numpy()))
                a_c = np.exp(-cfg.rglru_c * softplus)
                assert (a_c > 0.9 - 1e-4).all() and (a_c < 0.999 + 1e-4).all()
