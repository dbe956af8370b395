"""Port parity: the trainer's compiled, donated step (``loop.StaticStep``,
``Trainer(jit=True, donate=True)``), the counterpart of the reference's
``jax.jit(step_fn, donate_argnums=(0,))``.

On the CPU the static-buffer step runs uncaptured, so every part but the
CUDA graph capture itself runs here: the host part (the dropout
generator seeded from ``step_seed``, the uniform planes drawn ahead of
the device part), the static inputs, the in-place writes, donation and
restore.  Held against the reference's jitted ``EventTrainer`` over
three steps, and against the port's own eager step bit for bit.  Inputs
come from numpy with a seed (params) and from the seeded DVS stream."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import params_pair
from repro.sparse_train import trainer as ref_trainer
from repro.train import loop as ref_loop
from repro_torch import optim
from repro_torch.core import snn
from repro_torch.launch import train as train_cli
from repro_torch.sparse_train import event_layer, loss
from repro_torch.sparse_train import trainer as ev_trainer
from repro_torch.train import loop
from repro_torch.tree import tree_leaves

HW, HIDDEN, T, B = 16, 32, 6, 4
CASES = {"dropout": (0.2, 1), "accum": (0.0, 2), "dropout_accum": (0.2, 2)}


def _tcfgs(rate):
    kw = dict(image_hw=HW, hidden=HIDDEN, num_steps=T, dropout_rate=rate)
    return ev_trainer.EventTrainConfig(**kw), ref_trainer.EventTrainConfig(**kw)


def _ref_uniforms(seed, step, accum):
    """The reference's dropout uniforms of one batch as (B, T, hidden):
    ``bernoulli(k, 1 - rate, (mb, hidden))`` is ``uniform(k, ...) <
    1 - rate``, with ``k`` the T-way split of ``fold_in(PRNGKey(seed),
    step)``, the same key for every microbatch."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), jnp.uint32(step))
    mb = B // accum
    u = np.stack([np.asarray(jax.random.uniform(k, (mb, HIDDEN), jnp.float32))
                  for k in jax.random.split(key, T)])  # (T, mb, hidden)
    return torch.from_numpy(np.concatenate([u.transpose(1, 0, 2)] * accum))


def _batches(n, tcfg, seed=0):
    """n port DVS batches on the CPU, and the same as reference batches."""
    it = ev_trainer.dvs_batches(seed, B, tcfg, device="cpu")
    port = [next(it) for _ in range(n)]
    ref = [{"spikes": jnp.asarray(b["spikes"].numpy()),
            "labels": jnp.asarray(b["labels"].numpy().astype(np.int32)),
            "step_seed": jnp.asarray(b["step_seed"].numpy().astype(np.uint32))}
           for b in port]
    return port, ref


def _leaves(state):
    return tree_leaves((state.params, state.opt_state))


@pytest.mark.parametrize("case", sorted(CASES))
def test_static_step_matches_the_reference_jitted_trainer(case):
    rate, accum = CASES[case]
    tcfg, ref_tcfg = _tcfgs(rate)
    seed = 3
    ref_t = ref_trainer.EventTrainer(ref_tcfg, energy_lambda=0.05,
                                     accum_steps=accum, seed=seed)
    port_t = ev_trainer.EventTrainer(tcfg, energy_lambda=0.05, use_kernel=True,
                                     accum_steps=accum, seed=seed, device="cpu")
    assert isinstance(port_t.step_fn, loop.StaticStep)
    ref_p, p = params_pair(ref_tcfg.snn_config(), seed=9)
    ref_state = ref_loop.TrainState(ref_p, ref_t.optimizer.init(ref_p),
                                    jnp.zeros((), jnp.int32))
    state = loop.TrainState(p, port_t.optimizer.init(p), 0)
    port_b, ref_b = _batches(3, tcfg)
    for pb, rb in zip(port_b, ref_b):
        if rate:  # the reference's masks, through the step's host part
            pb = {**pb, "dropout_u": _ref_uniforms(
                seed, int(pb["step_seed"][0]), accum)}
        state, m = port_t.step_fn(state, pb)
        ref_state, ref_m = ref_t.step_fn(ref_state, rb)
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   atol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(ref_m["grad_norm"]), rtol=1e-4)
        if accum == 1:
            np.testing.assert_allclose(float(m["events_l0"]),
                                       float(ref_m["events_l0"]), rtol=1e-6)
        for x, y in zip(tree_leaves(state.params),
                        jax.tree_util.tree_leaves(ref_state.params)):
            np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5)
    assert state.step == 3 and int(ref_state.step) == 3
    assert port_t.step_fn.captures == 1  # one batch signature


def _run_steps(trainer, n, seed=0):
    state = trainer.init_state(seed)
    it = ev_trainer.dvs_batches(seed, B, trainer.tcfg, device="cpu")
    out = []
    for _ in range(n):
        state, m = trainer.step_fn(state, next(it))
        out.append(([x.clone() for x in _leaves(state)],
                    {k: v.clone() for k, v in m.items()}))
    return out


@pytest.mark.parametrize("case", ["plain"] + sorted(CASES))
def test_static_step_equals_the_eager_step_bit_for_bit(case):
    rate, accum = CASES.get(case, (0.0, 1))
    tcfg, _ = _tcfgs(rate)

    def make(jit):
        return ev_trainer.EventTrainer(tcfg, energy_lambda=0.05, seed=1,
                                       accum_steps=accum, device="cpu", jit=jit)

    graphed, eager = _run_steps(make(True), 3), _run_steps(make(False), 3)
    for (gl, gm), (el, em) in zip(graphed, eager):
        assert all(torch.equal(x, y) for x, y in zip(gl, el))
        assert gm.keys() == em.keys()
        assert all(torch.equal(gm[k], em[k]) for k in gm), case


def test_predrawn_dropout_planes_equal_the_per_step_draw():
    cfg = snn.SNNConfig(layer_sizes=(48, 20, 2), num_steps=5, dropout_rate=0.3)
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.random((5, 3, 48)) < 0.3).astype(np.float32))
    p = snn.init_params(torch.Generator().manual_seed(2), cfg, "cpu")
    planes = event_layer.dropout_planes(torch.Generator().manual_seed(7), 5, 3, 20)
    gen = torch.Generator().manual_seed(7)
    drawn = torch.stack([torch.rand((3, 20), generator=gen) for _ in range(5)])
    assert planes.shape == (5, 3, 20) and torch.equal(planes, drawn)
    spk = (torch.from_numpy(rng.random((3, 20))) < 0.5).float()
    assert torch.equal(
        snn.apply_dropout(spk, planes[0], 0.3),
        snn.dropout(spk, 0.3, torch.Generator().manual_seed(7)))
    by_gen = event_layer.event_bptt_forward(
        p, x, cfg, train=True, generator=torch.Generator().manual_seed(7))
    by_planes = event_layer.event_bptt_forward(p, x, cfg, train=True,
                                               dropout_u=planes)
    assert all(torch.equal(a, b) for a, b in zip(by_gen, by_planes))
    # the model's two parts against the one-piece loss it replaced
    model = ev_trainer.EventSNNModel(cfg, energy_lambda=0.1, seed=4,
                                     device="cpu")
    batch = {"spikes": x.transpose(0, 1), "labels": torch.tensor([0, 1, 1]),
             "step_seed": torch.full((3,), 11, dtype=torch.int64)}
    prepared = model.prepare(batch)
    assert prepared["dropout_u"].shape == (3, 5, 20)
    assert model.prepare(prepared) is prepared
    got, gm = model.loss(p, prepared)
    want, wm = loss.event_loss_fn(
        p, x, batch["labels"], cfg, energy_lambda=0.1, train=True,
        generator=torch.Generator().manual_seed(ev_trainer._mix(4, 11)))
    assert torch.equal(got, want)
    assert all(torch.equal(gm[k], wm[k]) for k in wm)
    nodrop = ev_trainer.EventSNNModel(
        snn.SNNConfig(layer_sizes=(48, 20, 2), num_steps=5, dropout_rate=0.0),
        device="cpu")
    assert nodrop.prepare(batch) is batch


def test_donated_state_is_updated_in_place():
    tcfg, _ = _tcfgs(0.2)
    tr = ev_trainer.EventTrainer(tcfg, device="cpu")
    state = tr.init_state(0)
    ptrs = [x.data_ptr() for x in _leaves(state)]
    it = ev_trainer.dvs_batches(0, B, tcfg, device="cpu")
    w0 = state.params["layer0"]["w"].clone()
    for _ in range(2):
        state, _ = tr.step_fn(state, next(it))
        assert [x.data_ptr() for x in _leaves(state)] == ptrs
    assert not torch.equal(state.params["layer0"]["w"], w0)
    assert tr.step_fn.captures == 1 and tr.step_fn.replays == 0  # CPU


def test_undonated_state_is_left_as_it_was():
    tcfg, _ = _tcfgs(0.2)
    tr = ev_trainer.EventTrainer(tcfg, device="cpu", donate=False)
    state = tr.init_state(0)
    before = [x.clone() for x in _leaves(state)]
    it = ev_trainer.dvs_batches(0, B, tcfg, device="cpu")
    new, _ = tr.step_fn(state, next(it))
    assert all(torch.equal(x, y) for x, y in zip(_leaves(state), before))
    ptrs = {x.data_ptr() for x in _leaves(state)}
    assert not ptrs & {x.data_ptr() for x in _leaves(new)}
    again, _ = tr.step_fn(new, next(it))
    assert not {x.data_ptr() for x in _leaves(new)} & {
        x.data_ptr() for x in _leaves(again)}
    assert new.step == 1 and again.step == 2


def test_a_new_batch_signature_sets_up_again_and_a_foreign_state_rebinds():
    tcfg, _ = _tcfgs(0.0)
    tr = ev_trainer.EventTrainer(tcfg, device="cpu", optimizer=optim.sgd(0.1))
    state = tr.init_state(0)
    for batch in (2, 2, 4, 2):
        state, _ = tr.step_fn(
            state, next(ev_trainer.dvs_batches(0, batch, tcfg, device="cpu")))
    assert tr.step_fn.captures == 2 and tr.step_fn._cache_size() == 2
    other = tr.init_state(1)
    out, _ = tr.step_fn(other, next(ev_trainer.dvs_batches(0, 2, tcfg,
                                                           device="cpu")))
    assert loop.same_storages(out.params, other.params)
    assert tr.step_fn.captures == 3  # the buffers moved: set up again


def test_trainer_takes_jit_and_donate_with_the_reference_defaults(monkeypatch):
    import inspect

    for cls in (loop.Trainer, ev_trainer.EventTrainer):
        sig = inspect.signature(cls.__init__).parameters
        assert sig["jit"].default is True and sig["donate"].default is True
    ref = inspect.signature(ref_loop.Trainer.__init__).parameters
    assert ref["jit"].default is True and ref["donate"].default is True
    tcfg, _ = _tcfgs(0.0)
    assert not isinstance(
        ev_trainer.EventTrainer(tcfg, device="cpu", jit=False).step_fn,
        loop.StaticStep)
    made = []
    real = ev_trainer.EventTrainer

    def record(*a, **kw):
        made.append(real(*a, **kw))
        return made[-1]

    monkeypatch.setattr(ev_trainer, "EventTrainer", record)
    train_cli.main(["--snn-events", "--device", "cpu", "--image-hw", "8",
                    "--hidden", "12", "--snn-steps", "4", "--batch", "2",
                    "--steps", "3"])
    step = made[0].step_fn
    assert isinstance(step, loop.StaticStep) and step.donate
    assert step.captures == 1
