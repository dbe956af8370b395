"""Each plain reference agrees with the port at a tiny size on the CPU,
in float32 (the port's own ops, not the benchmark's comparison)."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench.cellbase import generator_seed
from portbench.drivers import lm_train, snn_serve, snn_train
from portbench.frozen import dvs
from portbench.refs import lm_ref, snn_ref

SNN = {"layer_sizes": [64, 16, 2], "num_steps": 25, "neuron_kind": "lif",
       "reset": "zero", "surrogate": "atan", "refractory_steps": 0,
       "dropout_rate": 0.2, "beta_init": 0.9, "threshold_init": 1.0}
LM = {"name": "tiny", "family": "dense", "num_layers": 2, "d_model": 64,
      "num_heads": 4, "num_kv_heads": 4, "head_dim": 16, "d_ff": 128,
      "vocab_size": 512, "mlp_kind": "swiglu", "norm_kind": "layernorm",
      "norm_eps": 1e-5, "qkv_bias": True, "tie_embeddings": False,
      "rope_theta": 10000.0, "rope_pct": 0.25, "dtype": "float32",
      "param_dtype": "float32", "remat": "none"}


def _planes(T=12, B=6, hw=8, seed=3):
    gen = torch.Generator().manual_seed(seed)
    stream, labels = dvs.dvs_collision_batch(
        gen, B, image_hw=hw, num_steps=T, capacity=T * hw * hw)
    return dvs.input_planes(stream, T, hw * hw, polarity_mode="signed"), labels


def test_snn_forward_matches_the_port():
    from repro_torch.core import snn

    planes, _ = _planes()
    params = snn_ref.init_params(torch.Generator().manual_seed(1),
                                 SNN["layer_sizes"], 0.9, 1.0, "cpu")
    cfg = snn_serve.snn_config(SNN)
    want_mem, want_spk = snn.forward(params, planes, cfg)
    mem, spk, ev = snn_ref.forward(params, planes)
    assert torch.equal(spk, want_spk)
    torch.testing.assert_close(mem, want_mem, rtol=1e-5, atol=1e-5)
    assert torch.equal(ev[0], (planes != 0).sum((0, 2)).float())


def test_snn_training_step_matches_the_port():
    """One step of the reference's BPTT, clip and Adam against the port's
    eager trainer step on the same weights, batch and dropout draws."""
    from repro_torch.sparse_train.trainer import (EventTrainConfig,
                                                   EventTrainer)
    from repro_torch.train.loop import TrainState

    mix = {"batch": 6, "num_steps": 8, "image_hw": 8, "polarity": "signed",
           "delta_threshold": 0.1, "capacity": 512, "lr": 5e-4, "clip": 1.0,
           "judged_steps": 1}
    seed = 2**31 + 11
    tcfg = EventTrainConfig(image_hw=8, num_steps=8, hidden=16,
                            polarity_mode="signed", dropout_rate=0.2)
    tr = EventTrainer(tcfg, use_kernel=True, seed=seed, device="cpu",
                      jit=False)
    params = snn_train.weights(SNN, seed, torch.device("cpu"))
    state = TrainState(params, tr.optimizer.init(params), 0)
    state, m = tr.step_fn(state, snn_train.batch_at(mix, seed, 0, "cpu"))
    ref = snn_train.reference(SNN, mix, seed, torch.device("cpu"))
    assert float(m["loss"]) == pytest.approx(ref["loss"][0], rel=1e-5)
    got = snn_train.flat(state.params)
    start = snn_train.flat(snn_train.weights(SNN, seed, torch.device("cpu")))
    for n, change in ref["change"].items():
        assert float(torch.linalg.vector_norm(got[n] - start[n])) == (
            pytest.approx(change, rel=1e-4, abs=1e-9))


def test_lm_forward_matches_the_port():
    from repro_torch.models.model import Model

    model = Model(lm_train.model_config(LM), "cpu")
    gen = torch.Generator().manual_seed(generator_seed(5))
    params = lm_ref.init_params(LM, gen, "cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, 512,
                                                               (2, 24)))
    want = model.forward_logits(params, {"tokens": tokens})
    got = lm_ref.StableLM(params, LM).logits(
        lm_ref.StableLM(params, LM).hidden(tokens))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_lm_training_steps_match_the_port():
    """Three steps of the reference's AdamW with clipping and warm-up
    against the port's eager trainer, float32, the same batches."""
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw, chain_clip, warmup_cosine
    from repro_torch.train.loop import Trainer, TrainState

    mix = {"batch": 2, "seq": 16, "judged_steps": 3,
           "optimizer": {"lr": 3e-3, "warmup": 2, "decay": 10, "b1": 0.9,
                         "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
                         "clip": 1.0}}
    hp, seed = mix["optimizer"], 9
    opt = chain_clip(adamw(warmup_cosine(hp["lr"], hp["warmup"], hp["decay"]),
                           b1=hp["b1"], b2=hp["b2"], eps=hp["eps"],
                           weight_decay=hp["weight_decay"]), hp["clip"])
    tr = Trainer(Model(lm_train.model_config(LM), "cpu"), opt, jit=False)
    params = lm_train.weights(LM, seed, "cpu")
    state = TrainState(params, opt.init(params), 0)
    losses = []
    for _, (x, y) in zip(range(3), lm_train.stream(LM, mix, seed)):
        state, m = tr.step_fn(state, {"tokens": torch.as_tensor(x),
                                      "targets": torch.as_tensor(y)})
        losses.append(float(m["loss"]))
    ref = lm_train.reference(LM, mix, seed, torch.device("cpu"))
    assert losses == pytest.approx(ref["loss"], rel=1e-5)
    got = lm_ref.leaves(state.params)
    start = lm_ref.leaves(lm_train.weights(LM, seed, "cpu"))
    for n, change in ref["change"].items():
        if ref["grad_raw"][n] > 1e-6:
            assert float(torch.linalg.vector_norm(got[n] - start[n])) == (
                pytest.approx(change, rel=1e-3))


def test_the_float8_control_rounds_and_passes_gradients():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = lm_ref.fp8(x)
    assert not torch.equal(y.detach(), x.detach())
    assert float((y - x).abs().max()) <= 3 * 2 ** -3
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
    assert dataclasses.is_dataclass(lm_train.model_config(LM))
