"""The LM zoo's training path of the port against the reference's on the
CPU: ``Model.loss`` and its gradients for the ten archs at ``reduced()``
size (the reference's params carried over by ``params_from_numpy``, the
same numpy batches), remat, the trainer's LM cases of
``tests/test_train_loop.py``, the graphed step's contract (uncaptured on
the CPU) and ``python -m repro_torch.launch.train``'s LM mode.  Loss
within 1e-5, gradients within atol = rtol = 1e-4."""

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models.model import CLIP_EMBED_DIM
from repro.models.model import Model as RefModel
import repro_torch.configs as configs
from repro_torch.data.tokens import MarkovTokenStream, TokenStreamConfig
from repro_torch.launch import train
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.optim import adam, chain_clip, sgd
from repro_torch.train.loop import TrainState, Trainer, make_train_step
from repro_torch.tree import (
    tree_flatten_with_names,
    tree_leaves,
    tree_unflatten,
)

ROOT = Path(__file__).resolve().parents[1]
LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
B, L = 2, 12


def port_cfg(ref_cfg):
    return ModelConfig(**dataclasses.asdict(ref_cfg))


def pair(ref_cfg, seed=1):
    """(reference model, its params, port model, the same params)."""
    rm = RefModel(ref_cfg)
    rp, _ = rm.init(jax.random.PRNGKey(seed))
    cfg = port_cfg(ref_cfg)
    rp_np = jax.tree_util.tree_map(np.asarray, rp)
    return rm, rp, Model(cfg, "cpu"), params_from_numpy(rp_np, cfg, "cpu")


def batch_np(cfg, seed=1, masked=0.0, one_token=False):
    """Tokens and targets (a share ``masked`` of them -1) from a seed, and
    a vlm's image embeddings; ``one_token``: every input token the same."""
    rng = np.random.default_rng(seed)
    shape = (B, L, cfg.num_codebooks) if cfg.num_codebooks else (B, L)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if one_token:
        batch["tokens"][:] = 7
    if masked:
        batch["targets"][rng.random(shape) < masked] = -1
    if cfg.num_image_tokens:
        batch["img_embeds"] = rng.normal(
            0, 1, (B, cfg.num_image_tokens, CLIP_EMBED_DIM)).astype(np.float32)
    return batch


def to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def check_loss_and_grads(ref_cfg, batch):
    rm, rp, model, params = pair(ref_cfg)
    (rloss, rmetrics), rgrads = jax.jit(
        jax.value_and_grad(rm.loss, has_aux=True))(
            rp, {k: jnp.asarray(v) for k, v in batch.items()})
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    names, _ = tree_flatten_with_names(params)
    loss, metrics = model.loss(tree_unflatten(params, live), to_torch(batch))
    grads = torch.autograd.grad(loss, live)
    np.testing.assert_allclose(float(loss.detach()), float(rloss), **LOSS_TOL)
    assert sorted(metrics) == sorted(rmetrics) == ["ce", "loss", "moe_aux",
                                                   "tokens"]
    for k, v in metrics.items():
        assert v.dim() == 0 and not v.requires_grad, k
        np.testing.assert_allclose(float(v), float(rmetrics[k]), **LOSS_TOL,
                                   err_msg=k)
    rnames, rleaves = tree_flatten_with_names(
        jax.tree_util.tree_map(np.asarray, rgrads))
    assert rnames == names
    for n, g, rg in zip(names, grads, rleaves):
        assert g.dtype == torch.from_numpy(rg.copy()).dtype, n
        np.testing.assert_allclose(g.numpy(), rg, err_msg=n, **GRAD_TOL)
    return float(loss.detach()), metrics


# ------------------------------------------------------------ loss, grads
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_loss_and_grads_match_reference(arch):
    """Each arch at its reduced config as the reference ships it (MoE at
    its default capacity_factor: tokens are dropped)."""
    ref_cfg = ref_configs.get(arch).reduced()
    check_loss_and_grads(ref_cfg, batch_np(ref_cfg))


LOSS_CASES = {  # arch, config overrides, share of targets masked, one token
    "q115": ("stablelm-1.6b", dict(quant="q115"), 0.0, False),
    "q1_7": ("stablelm-1.6b", dict(quant="q1_7"), 0.0, False),
    "masked_targets": ("stablelm-1.6b", {}, 0.4, False),
    "all_targets_masked": ("stablelm-1.6b", {}, 1.0, False),
    # one token everywhere: every token picks the same experts, so the
    # default capacity_factor (1.25) drops most of them
    "moe_default_capacity_drops": ("mixtral-8x7b", {}, 0.3, True),
    "vlm_masked": ("phi-3-vision-4.2b", {}, 0.3, False),
    "musicgen_masked": ("musicgen-medium", {}, 0.3, False),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_cases_match_reference(case):
    arch, overrides, masked, one_token = LOSS_CASES[case]
    ref_cfg = dataclasses.replace(ref_configs.get(arch).reduced(), **overrides)
    batch = batch_np(ref_cfg, seed=2, masked=masked, one_token=one_token)
    _, metrics = check_loss_and_grads(ref_cfg, batch)
    assert float(metrics["tokens"]) == float((batch["targets"] >= 0).sum())


def test_moe_default_capacity_drops_repeated_tokens():
    """The MoE case above runs with drops, not around them."""
    from repro_torch.models import moe

    cfg = configs.get("mixtral-8x7b").reduced()
    x = torch.randn(cfg.d_model, generator=torch.Generator().manual_seed(0))
    params = Model(cfg, "cpu").init(1)
    ffn = {k: v[0] for k, v in params["main"]["b0"]["ffn"].items()}
    _, aux = moe.moe_forward(ffn, x.expand(B, L, -1), cfg)
    assert float(aux["moe_dropped_frac"]) >= 0.3


# ----------------------------------------------------------------- remat
REMAT_ARCHS = ["stablelm-1.6b", "granite-moe-1b-a400m", "mamba2-130m",
               "recurrentgemma-2b", "minicpm3-4b"]


def _grads(cfg, seed=3):
    model = Model(cfg, "cpu")
    params = model.init(seed)
    batch = to_torch(batch_np(cfg, seed=seed, masked=0.2))
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    saved = []

    def pack(t):
        saved.append(t.numel() * t.element_size())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss, _ = model.loss(tree_unflatten(params, live), batch)
    return loss, torch.autograd.grad(loss, live), sum(saved)


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_gradients_equal_no_remat_bit_for_bit(arch, remat):
    cfg = configs.get(arch).reduced()
    loss0, g0, saved0 = _grads(dataclasses.replace(cfg, remat="none"))
    loss1, g1, saved1 = _grads(dataclasses.replace(cfg, remat=remat))
    assert torch.equal(loss0, loss1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    # the checkpoint is taken: the forward keeps fewer bytes for backward
    assert saved1 < saved0, (saved1, saved0)


def test_remat_leaves_inference_as_it_was():
    cfg = configs.get("stablelm-1.6b").reduced()
    params = Model(cfg, "cpu").init(0)
    batch = to_torch(batch_np(cfg))
    outs = [Model(dataclasses.replace(cfg, remat=r), "cpu").forward_logits(
        params, batch) for r in ("none", "full", "dots")]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


# ------------------------------------------- the trainer (test_train_loop)
def _tiny_cfg(**overrides):
    return configs.get("stablelm-1.6b").reduced(
        num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=128, **overrides)


def _batches(cfg, batch=4, seq=16):
    stream = MarkovTokenStream(TokenStreamConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, batch_size=batch))
    for x, y in stream.batches():
        yield {"tokens": torch.from_numpy(x), "targets": torch.from_numpy(y)}


def test_trainer_takes_the_lm_model():
    """``Trainer(Model(cfg), opt)`` as the reference's: the model's params
    on its device, Adam state beside them."""
    tr = Trainer(Model(_tiny_cfg(), "cpu"), adam(1e-3))
    state = tr.init_state(0)
    assert state.step == 0
    assert tree_flatten_with_names(state.params)[0] == tree_flatten_with_names(
        Model(_tiny_cfg()).abstract())[0]
    assert all(p.device.type == "cpu" for p in tree_leaves(state.params))
    assert len(tree_leaves(state.opt_state.mu)) == len(tree_leaves(state.params))


def test_loss_decreases_on_markov_stream():
    cfg = _tiny_cfg()
    trainer = Trainer(Model(cfg, "cpu"), chain_clip(adam(3e-3), 1.0))
    state = trainer.init_state(0)
    logs = []
    state, metrics = trainer.run(state, _batches(cfg), num_steps=30,
                                 log_every=29, log_fn=logs.append)
    first = float(logs[0].split("loss=")[1].split(" ")[0])
    assert metrics["loss"] < first


def test_grad_accumulation_matches_full_batch():
    """accum_steps=2 over a 2x batch == one step over the full batch,
    through an SGD step (update linear in grads), as the reference's."""
    cfg = _tiny_cfg()
    model = Model(cfg, "cpu")
    opt = sgd(lr=0.1, momentum=0.0)
    batch = next(_batches(cfg, batch=8))
    params = model.init(0)
    out1, _ = make_train_step(model, opt, 1)(
        TrainState(params, opt.init(params), 0), batch)
    out2, _ = make_train_step(model, opt, 2)(
        TrainState(params, opt.init(params), 0), batch)
    for a, b, p0 in zip(tree_leaves(out1.params), tree_leaves(out2.params),
                        tree_leaves(params)):
        np.testing.assert_allclose((a - p0).numpy(), (b - p0).numpy(),
                                   rtol=1e-3, atol=1e-6)


def test_checkpoint_restart_resumes(tmp_path):
    cfg = _tiny_cfg()
    trainer = Trainer(Model(cfg, "cpu"), adam(1e-3), ckpt_dir=str(tmp_path),
                      ckpt_every=5)
    state = trainer.restore_or_init(0)
    state, _ = trainer.run(state, _batches(cfg), num_steps=6,
                           log_fn=lambda s: None)
    trainer2 = Trainer(Model(cfg, "cpu"), adam(1e-3), ckpt_dir=str(tmp_path),
                       ckpt_every=5)
    state2 = trainer2.restore_or_init(99)
    assert state2.step == state.step == 6
    for a, b in zip(tree_leaves(state.params), tree_leaves(state2.params)):
        assert torch.equal(a, b)


GRAPH_ARCHS = ["stablelm-1.6b", "granite-moe-1b-a400m", "musicgen-medium",
               "phi-3-vision-4.2b", "recurrentgemma-2b"]


def _launcher_opt(steps=3):
    return train.lm_optimizer(3e-4, steps)


@pytest.mark.parametrize("arch", GRAPH_ARCHS)
def test_static_step_equals_eager_bit_for_bit(arch):
    """``Trainer(jit=True)``'s static step (leaf-by-leaf writes into its
    buffers; uncaptured on the CPU) against ``jit=False``'s eager step over
    3 steps, with the launcher's optimizer and remat on."""
    cfg = dataclasses.replace(configs.get(arch).reduced(), remat="full")
    runs = []
    for jit in (True, False):
        tr = Trainer(Model(cfg, "cpu"), _launcher_opt(), jit=jit)
        state = tr.init_state(0)
        losses = []
        for _, batch in zip(range(3), train.batches(cfg, 2, 8, "cpu")):
            state, m = tr.step_fn(state, batch)
            losses.append(m["loss"].clone())
        runs.append((state, losses, m))
    (s1, l1, m1), (s2, l2, m2) = runs
    assert s1.step == s2.step == 3
    for a, b in zip(l1, l2):
        assert torch.equal(a, b)
    assert sorted(m1) == sorted(m2)
    for k in m1:
        assert torch.equal(m1[k], m2[k]), k
    for a, b in zip(tree_leaves((s1.params, s1.opt_state)),
                    tree_leaves((s2.params, s2.opt_state))):
        assert torch.equal(a, b)


def test_static_step_writes_in_place_and_holds_no_state_copy():
    """Donated state: the step returns the buffers it was given, advanced;
    the warm-up made no copy of them (only the leaf rule's temporaries)."""
    cfg = _tiny_cfg()
    tr = Trainer(Model(cfg, "cpu"), _launcher_opt())
    state = tr.init_state(0)
    ptrs = [t.data_ptr() for t in tree_leaves((state.params, state.opt_state))]
    before = [t.clone() for t in tree_leaves(state.params)]
    batches = _batches(cfg)
    for _ in range(2):
        state, _ = tr.step_fn(state, next(batches))
    assert [t.data_ptr() for t in tree_leaves(
        (state.params, state.opt_state))] == ptrs
    assert int(state.opt_state.count) == 2
    assert any(not torch.equal(a, b)
               for a, b in zip(before, tree_leaves(state.params)))


def test_port_trainer_follows_the_reference_trainer():
    """3 SGD steps of the port's graphed trainer and the reference's jitted
    one from the same params on the same batches."""
    from repro.optim import sgd as ref_sgd
    from repro.train.loop import Trainer as RefTrainer
    from repro.train.loop import TrainState as RefTrainState

    ref_cfg = ref_configs.get("stablelm-1.6b").reduced(
        num_layers=2, d_model=64, num_heads=2, num_kv_heads=2, head_dim=32,
        d_ff=128, vocab_size=128)
    rm, rp, model, params = pair(ref_cfg, seed=0)
    rt = RefTrainer(rm, ref_sgd(0.1))
    pt = Trainer(model, sgd(0.1))
    opt = sgd(0.1)
    rstate = RefTrainState(rp, rt.optimizer.init(rp), jnp.zeros((), jnp.int32))
    pstate = TrainState(params, opt.init(params), 0)
    stream = MarkovTokenStream(TokenStreamConfig(vocab_size=128, seq_len=16,
                                                 batch_size=4))
    for _, (x, y) in zip(range(3), stream.batches()):
        rstate, rmetrics = rt.step_fn(rstate, {"tokens": jnp.asarray(x),
                                               "targets": jnp.asarray(y)})
        pstate, pmetrics = pt.step_fn(pstate, {"tokens": torch.from_numpy(x),
                                               "targets": torch.from_numpy(y)})
        np.testing.assert_allclose(float(pmetrics["loss"]),
                                   float(rmetrics["loss"]), **LOSS_TOL)
    rn, rl = tree_flatten_with_names(
        jax.tree_util.tree_map(np.asarray, rstate.params))
    pn, pl = tree_flatten_with_names(pstate.params)
    assert rn == pn
    for n, a, b in zip(rn, rl, pl):
        np.testing.assert_allclose(b.numpy(), a, err_msg=n, **GRAD_TOL)


# ------------------------------------------------------------- launcher
RUN = """
import sys
from repro_torch.launch.train import main
main({argv!r})
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))
assert not bad, bad
"""


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_train_launcher_lm_mode_on_cpu_without_jax(arch):
    argv = ["--arch", arch, "--reduced", "--steps", "2", "--device", "cpu",
            "--batch", "2", "--seq", "16"]
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(argv=argv)], cwd=ROOT,
        capture_output=True, text=True, timeout=240,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "2"},
    )
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith(f"arch={arch} params=") and "(active " in lines[0]
    final = [ln for ln in lines if ln.startswith("final: ")]
    assert len(final) == 1 and "'loss': " in final[0], out.stdout
    assert "captures 1, graph replays 0 (the CPU runs it uncaptured)" in lines[-1]


def test_train_launcher_lm_needs_the_card_unless_told_cpu(monkeypatch):
    """The default mode is the LM; with no GPU and no --device it raises
    rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "mamba2-130m", "--reduced", "--steps", "1"])


class _Stop(Exception):
    pass


def test_train_launcher_flags_keep_the_reference_defaults(monkeypatch):
    from repro.launch import train as ref_train

    seen = []
    parse = argparse.ArgumentParser.parse_args

    def capture(self, *a, **k):
        seen.append(vars(parse(self, *a, **k)))
        raise _Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    for mod in (train, ref_train):
        with pytest.raises(_Stop):
            mod.main([])
    port, ref = seen
    assert set(ref) <= set(port) and set(port) - set(ref) == {"device"}
    for key in ref:
        assert port[key] == ref[key], key
    assert port["arch"] == "stablelm-1.6b" and not port["snn_events"]


@pytest.mark.parametrize("mode", ["lm", "snn"])
def test_train_launcher_lr_resolves_as_the_reference(monkeypatch, mode):
    """``--lr`` unset: 3e-4 for an LM (into the warm-up cosine schedule),
    the paper's 5e-4 for --snn-events (into the event trainer)."""
    from repro.launch import train as ref_train
    import repro.sparse_train.trainer as ref_ev
    import repro_torch.sparse_train.trainer as port_ev

    seen = []

    def record(lr, *a, **k):
        seen.append(lr)
        raise _Stop

    def record_trainer(*a, lr=None, **k):
        seen.append(lr)
        raise _Stop

    monkeypatch.setattr(train, "warmup_cosine", record)
    monkeypatch.setattr(ref_train, "warmup_cosine", record)
    monkeypatch.setattr(port_ev, "EventTrainer", record_trainer)
    monkeypatch.setattr(ref_ev, "EventTrainer", record_trainer)
    argv = (["--snn-events", "--device", "cpu"] if mode == "snn"
            else ["--reduced", "--device", "cpu"])
    with pytest.raises(_Stop):
        train.main(argv)
    with pytest.raises(_Stop):
        ref_train.main([a for a in argv if a not in ("--device", "cpu")])
    assert seen == ([5e-4, 5e-4] if mode == "snn" else [3e-4, 3e-4])


def test_launcher_batches_are_the_reference_launchers():
    """Tokens, targets and image embeddings of ``batches`` equal the
    reference launcher's, array for array, for a codebook and a vlm arch."""
    from repro.launch import train as ref_train

    for arch in ("musicgen-medium", "phi-3-vision-4.2b", "stablelm-1.6b"):
        cfg = configs.get(arch).reduced()
        rcfg = ref_configs.get(arch).reduced()
        port = train.batches(cfg, 2, 8, "cpu")
        ref = ref_train.batches(rcfg, 2, 8)
        for _ in range(2):
            pb, rb = next(port), next(ref)
            assert sorted(pb) == sorted(rb)
            for k in rb:
                np.testing.assert_array_equal(pb[k].numpy(), np.asarray(rb[k]))
