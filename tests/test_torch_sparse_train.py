"""Port parity: event-driven training (event layer, energy-aware loss,
optimizers, obs copies, the EventTrainer and its checkpoints) against the
JAX reference, on shared numpy-seeded inputs."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_parity import np_tree, params_pair, port_cfg, spikes, t
from repro.core import snn as ref_snn
from repro.obs.metrics import MetricsRegistry as RefRegistry
from repro.obs.timeseries import TimeSeriesSampler as RefSampler
from repro.obs.trace import TraceRecorder as RefTrace
from repro import optim as ref_optim
from repro.optim.adam import apply_updates as ref_apply_updates
from repro.sparse_train import event_layer as ref_event_layer
from repro.sparse_train import loss as ref_loss
from repro.sparse_train import trainer as ref_trainer
from repro.train import loop as ref_loop
from repro_torch import optim
from repro_torch.core import snn
from repro_torch.kernels import aer_matmul
from repro_torch.launch import train as train_cli
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.timeseries import TimeSeriesSampler
from repro_torch.obs.trace import TraceRecorder
from repro_torch.sparse_train import event_layer, loss
from repro_torch.sparse_train import trainer as ev_trainer
from repro_torch.train import loop
from repro_torch.tree import tree_leaves, tree_map

RNG = np.random.default_rng(31)


def _assert_tree_close(port_tree, ref_tree, atol, rtol=0.0):
    ref = np_tree(ref_tree) if isinstance(ref_tree, dict) else ref_tree
    for name, lp in ref.items():
        for k, v in lp.items():
            np.testing.assert_allclose(
                port_tree[name][k].detach().numpy(), np.asarray(v),
                atol=atol, rtol=rtol, err_msg=f"{name}/{k}",
            )


# ------------------------------------------------------------ event layer
@pytest.mark.parametrize("use_kernel", [False, True])
def test_event_linear_forward_and_gradients_match_reference(use_kernel):
    B, K, N = 4, 50, 16
    h = spikes(RNG, (B, K), 0.25, signed=True)
    w = RNG.normal(size=(K, N)).astype(np.float32)
    b = RNG.normal(size=(N,)).astype(np.float32)
    target = RNG.normal(size=(B, N)).astype(np.float32)

    def ref_obj(h, w, b):
        out = ref_event_layer.event_linear(h, w, b, use_kernel=use_kernel)
        return jnp.sum((out - target) ** 2), out

    (_, ref_out), ref_g = jax.value_and_grad(ref_obj, argnums=(0, 1, 2),
                                             has_aux=True)(
        jnp.asarray(h), jnp.asarray(w), jnp.asarray(b))
    ht, wt, bt = (t(x).requires_grad_(True) for x in (h, w, b))
    out = event_layer.event_linear(ht, wt, bt, use_kernel=use_kernel)
    torch.sum((out - t(target)) ** 2).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=1e-5, rtol=1e-5)
    for got, ref in zip((ht.grad, wt.grad, bt.grad), ref_g):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   atol=1e-4, rtol=1e-4)
    # the weight gradient lives only on rows that carried events
    assert not wt.grad.numpy()[~(h != 0).any(axis=0)].any()


def test_event_linear_skips_the_input_gradient_of_data():
    h = t(spikes(RNG, (3, 20), 0.3)).requires_grad_(True)
    w = t(RNG.normal(size=(20, 4)).astype(np.float32)).requires_grad_(True)
    b = torch.zeros(4, requires_grad=True)
    out = event_layer.event_linear(h, w, b, needs_input_grad=False)
    gh, gw = torch.autograd.grad(out.sum(), (h, w), allow_unused=True)
    assert gh is None and gw is not None


def test_event_linear_capacity_truncates_forward_and_weight_gradient():
    h = spikes(RNG, (3, 30), 0.5)
    w = RNG.normal(size=(30, 5)).astype(np.float32)
    b = np.zeros(5, np.float32)
    wt = t(w).requires_grad_(True)
    out = event_layer.event_linear(t(h), wt, t(b), capacity=4,
                                   use_kernel=True, needs_input_grad=False)
    out.sum().backward()
    ref_out, ref_vjp = jax.vjp(
        lambda w: ref_event_layer.event_linear(
            jnp.asarray(h), w, jnp.asarray(b), capacity=4,
            needs_input_grad=False),
        jnp.asarray(w))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        wt.grad.numpy(), np.asarray(ref_vjp(jnp.ones_like(ref_out))[0]),
        atol=1e-4, rtol=1e-4)


# ------------------------------------------------------ energy-aware loss
def _loss_case(sizes, T, B, rate, signed=False, quant=False, seed=0):
    ref_cfg = ref_snn.SNNConfig(layer_sizes=sizes, num_steps=T,
                                dropout_rate=0.0, quant_q115=quant)
    ref_p, p = params_pair(ref_cfg, seed)
    x = spikes(RNG, (T, B, sizes[0]), rate, signed=signed)
    labels = RNG.integers(0, 2, B)
    return ref_cfg, port_cfg(ref_cfg), ref_p, p, x, labels


@pytest.mark.parametrize("case", ["rate0.05", "rate0.3", "rate0.8", "signed",
                                  "q115"])
def test_event_loss_gradients_match_reference(case):
    rate = {"rate0.05": 0.05, "rate0.8": 0.8}.get(case, 0.3)
    ref_cfg, cfg, ref_p, p, x, labels = _loss_case(
        (64, 24, 2), 8, 3, rate, signed=case == "signed",
        quant=case == "q115")
    lam = 0.3 if case == "rate0.3" else 0.0

    def ref_fn(params):
        return ref_loss.event_loss_fn(params, jnp.asarray(x),
                                      jnp.asarray(labels), ref_cfg,
                                      energy_lambda=lam, train=False)

    (ref_l, ref_m), ref_g = jax.value_and_grad(ref_fn, has_aux=True)(ref_p)
    live = tree_map(lambda v: v.requires_grad_(True), p)
    l, m = loss.event_loss_fn(live, t(x), t(labels), cfg, energy_lambda=lam,
                              train=False, use_kernel=True)
    l.backward()
    np.testing.assert_allclose(float(l.detach()), float(ref_l), atol=2e-5,
                               rtol=2e-5)
    for k in ref_m:
        np.testing.assert_allclose(float(m[k]), float(ref_m[k]), rtol=1e-5,
                                   err_msg=k)
    grads = {n: {k: v.grad for k, v in lp.items()} for n, lp in live.items()}
    _assert_tree_close(grads, ref_g, atol=2e-5, rtol=2e-5)


def test_dense_loss_and_bptt_forward_match_reference():
    ref_cfg, cfg, ref_p, p, x, labels = _loss_case((40, 12, 2), 6, 2, 0.3)
    ref_fn = lambda q: ref_snn.loss_fn(q, jnp.asarray(x), jnp.asarray(labels),
                                       ref_cfg, train=False)
    (ref_l, _), ref_g = jax.value_and_grad(ref_fn, has_aux=True)(ref_p)
    live = tree_map(lambda v: v.requires_grad_(True), p)
    l, _ = snn.loss_fn(live, t(x), t(labels), cfg, train=False)
    l.backward()
    np.testing.assert_allclose(float(l.detach()), float(ref_l), atol=2e-5,
                               rtol=2e-5)
    grads = {n: {k: v.grad for k, v in lp.items()} for n, lp in live.items()}
    _assert_tree_close(grads, ref_g, atol=2e-5, rtol=2e-5)
    em, es, ev, act = event_layer.event_bptt_forward(p, t(x), cfg)
    r_em, r_es, r_ev, r_act = ref_event_layer.event_bptt_forward(
        ref_p, jnp.asarray(x), ref_cfg)
    np.testing.assert_allclose(em.detach().numpy(), np.asarray(r_em),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(es.detach().numpy(), np.asarray(r_es))
    np.testing.assert_array_equal(ev.numpy(), np.asarray(r_ev))
    np.testing.assert_allclose(act.detach().numpy(), np.asarray(r_act),
                               rtol=1e-6)


def test_dropout_draws_come_from_the_generator():
    ref_cfg, cfg, _, p, x, _ = _loss_case((40, 12, 2), 6, 2, 0.4)
    cfg = snn.SNNConfig(**{**cfg.__dict__, "dropout_rate": 0.5})
    with pytest.raises(ValueError, match="generator"):
        snn.forward(p, t(x), cfg, train=True)
    runs = [
        event_layer.event_bptt_forward(
            p, t(x), cfg, train=True,
            generator=torch.Generator().manual_seed(s))[0]
        for s in (4, 4, 5)
    ]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    h = torch.ones(200, 300)
    kept = snn.dropout(h, 0.5, torch.Generator().manual_seed(0))
    assert set(kept.unique().tolist()) == {0.0, 2.0}
    assert abs(float((kept > 0).float().mean()) - 0.5) < 0.02
    assert torch.equal(snn.forward(p, t(x), cfg)[0],
                       snn.forward(p, t(x), cfg, train=False)[0])


def test_measured_energy_matches_reference():
    sizes, T = (256, 64, 2), 15
    ev = np.array([[731.0, 12.0], [88.0, 3.5]], np.float32)
    np.testing.assert_allclose(
        loss.measured_energy_pj(sizes, T, t(ev)).numpy(),
        np.asarray(ref_loss.measured_energy_pj(sizes, T, jnp.asarray(ev))),
        rtol=1e-6)
    assert loss.event_cost_pj(512) == ref_loss.event_cost_pj(512)


# --------------------------------------------------------------- optim
def _grads_and_params():
    shapes = {"layer0": {"w": (7, 5), "b": (5,)}, "layer1": {"w": (5, 2)}}
    mk = lambda s: RNG.normal(0, 1, s).astype(np.float32)
    return ({n: {k: mk(s) for k, s in lp.items()} for n, lp in shapes.items()},
            {n: {k: mk(s) for k, s in lp.items()} for n, lp in shapes.items()})


@pytest.mark.parametrize("name", ["adam_clip", "adamw_cosine", "sgd"])
def test_optimizer_updates_match_reference(name):
    g_np, p_np = _grads_and_params()
    g_np["layer0"]["w"][0, 0] = 0.0
    if name == "adam_clip":
        port_opt, ref_opt = (optim.chain_clip(optim.adam(5e-4), 1.0),
                             ref_optim.chain_clip(ref_optim.adam(5e-4), 1.0))
    elif name == "adamw_cosine":
        port_opt = optim.adamw(optim.warmup_cosine(1e-3, 1, 10))
        ref_opt = ref_optim.adamw(ref_optim.warmup_cosine(1e-3, 1, 10))
    else:
        port_opt, ref_opt = optim.sgd(0.1), ref_optim.sgd(0.1)
    to_t = lambda tr: tree_map(lambda x: t(x), tr)
    to_j = lambda tr: jax.tree_util.tree_map(jnp.asarray, tr)
    params, ref_params = to_t(p_np), to_j(p_np)
    state, ref_state = port_opt.init(params), ref_opt.init(ref_params)
    for _ in range(3):  # the bias correction moves with the count
        upd, state = port_opt.update(to_t(g_np), state, params)
        ref_upd, ref_state = ref_opt.update(to_j(g_np), ref_state, ref_params)
        params = optim.apply_updates(params, upd)
        ref_params = ref_apply_updates(ref_params, ref_upd)
        _assert_tree_close(upd, ref_upd, atol=1e-7)
        _assert_tree_close(params, ref_params, atol=1e-7)
    np.testing.assert_allclose(float(optim.global_norm(to_t(g_np))),
                               float(ref_optim.global_norm(to_j(g_np))),
                               rtol=1e-6)


@pytest.mark.parametrize("step", [0, 1, 5, 30])
def test_schedules_match_reference(step):
    s = jnp.asarray(step, jnp.int32)
    st = torch.tensor(step, dtype=torch.int32)
    for port, ref in (
        (optim.constant(3e-4), ref_optim.constant(3e-4)),
        (optim.cosine_decay(1e-3, 20, 0.1), ref_optim.cosine_decay(1e-3, 20, 0.1)),
        (optim.warmup_cosine(1e-3, 3, 20), ref_optim.warmup_cosine(1e-3, 3, 20)),
    ):
        np.testing.assert_allclose(float(port(st)), float(ref(s)), rtol=1e-6)


# ----------------------------------------------------------- obs copies
def test_obs_copies_export_what_the_reference_exports(tmp_path):
    outs = []
    for Registry, Trace, Sampler in ((RefRegistry, RefTrace, RefSampler),
                                     (MetricsRegistry, TraceRecorder,
                                      TimeSeriesSampler)):
        reg, trace = Registry(), Trace(capacity=8)
        series = Sampler(reg, capacity=16)
        c, g = reg.counter("train.steps"), reg.gauge("train.metrics.loss")
        h = reg.histogram("train.step_time_s", lo=1e-5, hi=1e4)
        for i, x in enumerate([0.02, 0.5, float("nan"), 3e-3, 0.02, 7.0]):
            c.inc(i)
            g.set(x)
            h.record(x)
            trace.span("window", 10.0 + i, 10.5 + i, track="train",
                       args={"step": i})
            series.sample(10.5 + i)
        trace.instant("straggler", 12.25, track="train", args={"step": 2})
        path = tmp_path / f"series{len(outs)}.jsonl"
        series.write_jsonl(path)
        outs.append((json.dumps(reg.snapshot(), sort_keys=True),
                     json.dumps(trace.chrome_trace(), sort_keys=True),
                     path.read_text(), series.rate("train.steps")))
    assert outs[0] == outs[1]


# ------------------------------------------------------------ the slice
def _dvs_tcfg():
    return ev_trainer.EventTrainConfig(image_hw=16, hidden=32, num_steps=6)


def _batches(n, tcfg, batch=4, seed=0):
    """n port DVS batches on the CPU, and the same as reference batches."""
    it = ev_trainer.dvs_batches(seed, batch, tcfg, device="cpu")
    port = [next(it) for _ in range(n)]
    ref = [{"spikes": jnp.asarray(b["spikes"].numpy()),
            "labels": jnp.asarray(b["labels"].numpy().astype(np.int32)),
            "step_seed": jnp.asarray(b["step_seed"].numpy().astype(np.uint32))}
           for b in port]
    return port, ref


def test_event_trainer_matches_reference_over_three_steps():
    tcfg = _dvs_tcfg()
    ref_tcfg = ref_trainer.EventTrainConfig(image_hw=16, hidden=32, num_steps=6)
    assert tcfg.input_size == 512
    ref_t = ref_trainer.EventTrainer(ref_tcfg, energy_lambda=0.05)
    port_t = ev_trainer.EventTrainer(tcfg, energy_lambda=0.05, use_kernel=True,
                                     device="cpu")
    ref_p, p = params_pair(ref_trainer.EventTrainConfig.snn_config(ref_tcfg),
                           seed=9)
    ref_state = ref_loop.TrainState(ref_p, ref_t.optimizer.init(ref_p),
                                    jnp.zeros((), jnp.int32))
    state = loop.TrainState(p, port_t.optimizer.init(p), 0)
    port_b, ref_b = _batches(3, tcfg)
    before = aer_matmul.aer_spike_matmul_batched.launches
    for pb, rb in zip(port_b, ref_b):
        state, m = port_t.step_fn(state, pb)
        ref_state, ref_m = ref_t.step_fn(ref_state, rb)
        np.testing.assert_allclose(float(m["loss"]), float(ref_m["loss"]),
                                   atol=1e-5)
        np.testing.assert_allclose(float(m["events_l0"]),
                                   float(ref_m["events_l0"]), rtol=1e-6)
        _assert_tree_close(state.params, ref_state.params, atol=1e-5)
    assert state.step == 3 and int(ref_state.step) == 3
    assert aer_matmul.aer_spike_matmul_batched.launches == before  # CPU
    ev = port_t.evaluate(state.params, port_b[0])
    ref_ev = ref_t.evaluate(ref_state.params, ref_b[0])
    np.testing.assert_array_equal(ev["predictions"].numpy(),
                                  np.asarray(ref_ev["predictions"]))
    np.testing.assert_allclose(ev["events_per_layer"].numpy(),
                               np.asarray(ref_ev["events_per_layer"]))


def test_dvs_batches_resume_at_start_step():
    tcfg = _dvs_tcfg()
    a = ev_trainer.dvs_batches(3, 2, tcfg, device="cpu")
    full = [next(a) for _ in range(3)]
    resumed = next(ev_trainer.dvs_batches(3, 2, tcfg, start_step=2,
                                          device="cpu"))
    for k in ("spikes", "labels", "step_seed"):
        assert torch.equal(resumed[k], full[2][k])
    assert not torch.equal(full[0]["spikes"], full[1]["spikes"])


def _run(trainer, state, n, start):
    it = ev_trainer.dvs_batches(0, 4, trainer.tcfg, start_step=start,
                                device="cpu")
    return trainer.run(state, it, n, log_every=1, log_fn=lambda _: None)


def test_checkpoint_resume_is_bit_identical(tmp_path):
    tcfg = ev_trainer.EventTrainConfig(image_hw=8, hidden=12, num_steps=5,
                                       dropout_rate=0.2)
    kw = dict(energy_lambda=0.05, use_kernel=True, device="cpu", seed=1)
    t3 = ev_trainer.EventTrainer(tcfg, **kw)
    s3, m3 = _run(t3, t3.init_state(7), 3, 0)
    t2 = ev_trainer.EventTrainer(tcfg, ckpt_dir=str(tmp_path), ckpt_every=1, **kw)
    _run(t2, t2.restore_or_init(7), 2, 0)
    t1 = ev_trainer.EventTrainer(tcfg, ckpt_dir=str(tmp_path), **kw)
    state = t1.restore_or_init(99)  # the seed comes back from the checkpoint
    assert state.step == 2 and t1.rng == 7
    assert t1.metrics.counter("train.steps").value == 2
    s1, m1 = _run(t1, state, 1, state.step)
    assert s1.step == 3 and m1 == m3
    for x, y in zip(tree_leaves(s1), tree_leaves(s3)):
        assert torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
    assert t1.metrics.counter("train.steps").value == 3


def test_corrupt_checkpoint_falls_back_to_the_previous_one(tmp_path):
    tcfg = ev_trainer.EventTrainConfig(image_hw=8, hidden=12, num_steps=4)
    tr = ev_trainer.EventTrainer(tcfg, ckpt_dir=str(tmp_path), ckpt_every=1,
                                 device="cpu")
    s2, _ = _run(tr, tr.init_state(0), 2, 0)
    npz = tmp_path / "step_0000000002" / "arrays.npz"
    raw = bytearray(npz.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    npz.write_bytes(bytes(raw))
    again = ev_trainer.EventTrainer(tcfg, ckpt_dir=str(tmp_path), device="cpu")
    with pytest.warns(UserWarning, match="integrity"):
        state = again.restore_or_init(0)
    assert state.step == 1 and again.ckpt.fallbacks == 1
    assert not torch.equal(state.params["layer0"]["w"], s2.params["layer0"]["w"])


def test_accumulated_step_averages_microbatch_gradients():
    tcfg = ev_trainer.EventTrainConfig(image_hw=8, hidden=12, num_steps=4)
    # donate=False: the case reuses ``state`` after each step, which a
    # donating step would consume (update in place)
    tr = ev_trainer.EventTrainer(tcfg, accum_steps=2, device="cpu",
                                 optimizer=optim.sgd(1.0, momentum=0.0),
                                 donate=False)
    one = ev_trainer.EventTrainer(tcfg, device="cpu", donate=False,
                                  optimizer=optim.sgd(1.0, momentum=0.0))
    state = tr.init_state(0)
    batch = next(ev_trainer.dvs_batches(0, 4, tcfg, device="cpu"))
    halves = [{k: v[i * 2:(i + 1) * 2] for k, v in batch.items()} for i in (0, 1)]
    s_acc, m = tr.step_fn(state, batch)
    deltas = [tree_map(lambda a, b: b - a, state.params,
                       one.step_fn(state, h)[0].params) for h in halves]
    want = tree_map(lambda p, a, b: p + (a + b) / 2, state.params, *deltas)
    for x, y in zip(tree_leaves(s_acc.params), tree_leaves(want)):
        torch.testing.assert_close(x, y, atol=1e-6, rtol=1e-5)
    assert set(m) == {"loss", "grad_norm"}


def test_train_launcher_runs_on_cpu_and_needs_a_gpu_by_default(capsys):
    train_cli.main(["--snn-events", "--device", "cpu", "--image-hw", "8",
                    "--hidden", "12", "--snn-steps", "4", "--polarity",
                    "signed", "--batch", "2", "--steps", "2"])
    out = capsys.readouterr().out
    assert "64-12-2" in out and "final:" in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["--snn-events", "--steps", "1"])
        # an LM (the default mode since its training was ported) needs
        # the card too
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_cli.main(["--arch", "stablelm-1.6b"])
