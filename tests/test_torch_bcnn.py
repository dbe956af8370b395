"""Port parity: the binarized CNN baseline (``core.bcnn``) against the JAX
reference on the CPU.  Weights are the reference's ``init_params`` draws,
carried across by ``params_from_numpy`` (HWIO -> OIHW); images are
collision scenes made with numpy.  Pre-sign activations must agree within
atol = rtol = 1e-5 layer by layer (each layer fed the reference's own
input), logits and gradients within 1e-4 end to end."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bcnn as ref_bcnn
from repro_torch.core import bcnn
from repro_torch.data import collision

CFGS = {
    "small": ref_bcnn.BCNNConfig(input_hw=16, channels=(4, 8, 8)),
    "deep": ref_bcnn.BCNNConfig(input_hw=16, channels=(4, 4, 8, 8)),
}


def _case(name, batch=6, seed=0):
    ref_cfg = CFGS[name]
    cfg = bcnn.BCNNConfig(**dataclasses.asdict(ref_cfg))
    ref_p = ref_bcnn.init_params(jax.random.PRNGKey(seed), ref_cfg)
    params_np = {n: {k: np.asarray(v) for k, v in lp.items()}
                 for n, lp in ref_p.items()}
    # non-trivial scales and biases, so the affine step is exercised
    rng = np.random.default_rng(seed)
    for n, lp in params_np.items():
        if n.startswith("conv"):
            lp["g"] = rng.uniform(0.5, 1.5, lp["g"].shape).astype(np.float32)
        lp["b"] = rng.normal(0, 0.1, lp["b"].shape).astype(np.float32)
    ref_p = jax.tree_util.tree_map(jnp.asarray, params_np)
    port_p = bcnn.params_from_numpy(params_np, "cpu")
    x, _, _, _ = collision.generate(collision.CollisionConfig(
        image_hw=ref_cfg.input_hw, num_train=batch, num_test=0, seed=seed))
    y = rng.integers(0, 2, batch).astype(np.int32)
    return ref_cfg, cfg, ref_p, port_p, x, y


def _ref_layers(params, images, cfg):
    """The reference's forward, keeping every block's pre-sign output and
    the input each block was fed (NHWC)."""
    x = images[..., None] * 2.0 - 1.0
    ins, outs = [], []
    n = len(cfg.channels)
    for i in range(n):
        lp = params[f"conv{i}"]
        ins.append(x)
        xin = x if i == 0 else ref_bcnn.binarize(x)
        x = ref_bcnn._conv(xin, ref_bcnn.binarize(lp["w"]))
        x = x * lp["g"] + lp["b"]
        if i < n - 1:
            x = ref_bcnn._maxpool2(x)
        outs.append(x)
    return ins, outs


def _nchw(x):
    return torch.from_numpy(np.array(np.asarray(x).transpose(0, 3, 1, 2)))


def test_binarize_forward_and_straight_through_gradient():
    x = np.array([-2.0, -1.0, -0.5, -0.0, 0.0, 1e-8, 0.5, 1.0, 1.5],
                 np.float32)
    g = np.arange(1, 10, dtype=np.float32)
    ref_y, vjp = jax.vjp(ref_bcnn.binarize, jnp.asarray(x))
    (ref_g,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    y = bcnn.binarize(xt)
    (gt,) = torch.autograd.grad(y, xt, torch.from_numpy(g))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(ref_y))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(ref_g))
    assert set(y.detach().tolist()) == {-1.0, 1.0}  # 0 maps to +1, not 0


def test_params_from_numpy_layout():
    ref_cfg, cfg, ref_p, port_p, _, _ = _case("small")
    for i, c_out in enumerate(cfg.channels):
        w = np.asarray(ref_p[f"conv{i}"]["w"])  # HWIO
        assert port_p[f"conv{i}"]["w"].shape == (c_out, w.shape[2], 3, 3)
        np.testing.assert_array_equal(port_p[f"conv{i}"]["w"].numpy(),
                                      w.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(port_p["fc"]["w"].numpy(),
                                  np.asarray(ref_p["fc"]["w"]))
    fresh = bcnn.init_params(torch.Generator().manual_seed(0), cfg)
    assert {n: {k: tuple(v.shape) for k, v in lp.items()}
            for n, lp in fresh.items()} == {
        n: {k: tuple(v.shape) for k, v in lp.items()}
        for n, lp in port_p.items()}


@pytest.mark.parametrize("name", sorted(CFGS))
def test_forward_layer_by_layer(name):
    ref_cfg, cfg, ref_p, port_p, x, _ = _case(name)
    ins, outs = _ref_layers(ref_p, jnp.asarray(x), ref_cfg)
    n = len(cfg.channels)
    for i in range(n):
        got = bcnn.conv_block(port_p, _nchw(ins[i]), i)
        if i < n - 1:
            got = torch.nn.functional.max_pool2d(got, 2)
        np.testing.assert_allclose(got.numpy(), np.asarray(_nchw(outs[i])),
                                   atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CFGS))
def test_logits_and_loss_end_to_end(name):
    ref_cfg, cfg, ref_p, port_p, x, y = _case(name)
    ref_logits = ref_bcnn.forward(ref_p, jnp.asarray(x), ref_cfg)
    logits = bcnn.forward(port_p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=1e-4, rtol=1e-4)
    layers = bcnn.forward_layers(port_p, torch.from_numpy(x), cfg)
    assert len(layers) == len(cfg.channels) + 1
    assert torch.equal(layers[-1], logits)
    ref_loss, ref_aux = ref_bcnn.loss_fn(ref_p, jnp.asarray(x),
                                         jnp.asarray(y), ref_cfg)
    loss, aux = bcnn.loss_fn(port_p, torch.from_numpy(x),
                             torch.from_numpy(y), cfg)
    assert float(loss) == pytest.approx(float(ref_loss), rel=1e-4, abs=1e-4)
    assert float(aux["accuracy"]) == float(ref_aux["accuracy"])


@pytest.mark.parametrize("name", sorted(CFGS))
def test_gradients_equal_reference(name):
    ref_cfg, cfg, ref_p, port_p, x, y = _case(name)
    ref_g = jax.grad(lambda p: ref_bcnn.loss_fn(
        p, jnp.asarray(x), jnp.asarray(y), ref_cfg)[0])(ref_p)
    live = {n: {k: v.clone().requires_grad_(True) for k, v in lp.items()}
            for n, lp in port_p.items()}
    loss, _ = bcnn.loss_fn(live, torch.from_numpy(x), torch.from_numpy(y),
                           cfg)
    loss.backward()
    ref_np = {n: {k: np.asarray(v) for k, v in lp.items()}
               for n, lp in ref_g.items()}
    for n, lp in live.items():
        for k, v in lp.items():
            want = ref_np[n][k]
            if n.startswith("conv") and k == "w":
                want = want.transpose(3, 2, 0, 1)
            np.testing.assert_allclose(v.grad.numpy(), want, atol=1e-4,
                                       rtol=1e-4, err_msg=f"{n}.{k}")


@pytest.mark.parametrize("name", ["default"] + sorted(CFGS))
def test_conv_shapes_for_energy_equal_reference(name):
    ref_cfg = CFGS.get(name, ref_bcnn.BCNNConfig())
    cfg = bcnn.BCNNConfig(**dataclasses.asdict(ref_cfg))
    assert bcnn.conv_shapes_for_energy(cfg) == ref_bcnn.conv_shapes_for_energy(
        ref_cfg)
