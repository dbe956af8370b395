"""The port's LM ``ServeEngine`` against the reference's on the CPU, on the
same params (carried by ``params_from_numpy``) and the same prompts; the
serve launcher's LM mode and the quantized-LM example in processes that
must not load JAX.  Greedy output is compared token for token; sampled
draws are not (the port samples from its own ``torch.Generator``)."""

import dataclasses
import functools
import subprocess
import sys
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models.model import Model as RefModel
from repro.serving.engine import Request as RefRequest
from repro.serving.engine import ServeEngine as RefEngine
import repro_torch.configs as configs
from repro_torch.launch import serve
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import CLIP_EMBED_DIM, Model, params_from_numpy
from repro_torch.serving.engine import Request, ServeEngine

ROOT = pathlib.Path(__file__).resolve().parents[1]
# one arch a family: dense, moe, ssm, hybrid, vlm, audio
FAMILY_ARCHS = ["stablelm-1.6b", "mixtral-8x7b", "mamba2-130m",
                "recurrentgemma-2b", "phi-3-vision-4.2b", "musicgen-medium"]


@functools.lru_cache(maxsize=None)
def engines(arch=None, B=4, cache_len=64):
    """(reference engine, port engine) on the same params.  With no arch,
    the reference's test_serving model: stablelm reduced to 2 layers,
    d_model 64, vocab 128."""
    if arch is None:
        rcfg = ref_configs.get("stablelm-1.6b").reduced(
            num_layers=2, d_model=64, num_heads=2, num_kv_heads=2,
            head_dim=32, d_ff=128, vocab_size=128)
    else:
        rcfg = ref_configs.get(arch).reduced()
    rm = RefModel(rcfg)
    rp, _ = rm.init(jax.random.PRNGKey(0))
    cfg = ModelConfig(**dataclasses.asdict(rcfg))
    pp = params_from_numpy(jax.tree_util.tree_map(np.asarray, rp), cfg, "cpu")
    return (RefEngine(rm, rp, batch_size=B, cache_len=cache_len),
            ServeEngine(Model(cfg), pp, batch_size=B, cache_len=cache_len))


def prompts(cfg, n, seed, lengths=(4, 24)):
    """Ragged prompts (and image embeddings) as the launcher makes them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        Lp = int(rng.integers(*lengths))
        shape = (Lp, cfg.num_codebooks) if cfg.num_codebooks else (Lp,)
        img = None
        if cfg.num_image_tokens:
            img = rng.normal(0, 1, (cfg.num_image_tokens, CLIP_EMBED_DIM)
                             ).astype(np.float32)
        out.append((rng.integers(0, cfg.vocab_size, shape).astype(np.int32),
                    img))
    return out


def ref_greedy_vlm(engine, prompt_list, new_tokens):
    """The reference engine's loop for a vlm model, on its jitted prefill
    and decode: its ``ServeEngine`` passes no image embeddings (a KeyError
    in ``Model._inputs``) and starts decoding at ``Lmax``, which for a vlm
    is the position of an image token (ROADMAP C10)."""
    cfg = engine.model.cfg
    outs = []
    for s in range(0, len(prompt_list), engine.B):
        chunk = prompt_list[s: s + engine.B]
        Lmax = max(len(p) for p, _ in chunk)
        toks = np.stack([np.pad(p, (0, Lmax - len(p))) for p, _ in chunk])
        img = np.stack([i for _, i in chunk])
        logits, cache = engine._prefill(
            engine.params, {"tokens": jnp.asarray(toks),
                            "img_embeds": jnp.asarray(img)})
        pos = jnp.full((len(chunk),), Lmax + cfg.num_image_tokens, jnp.int32)
        tok = jnp.argmax(logits, -1)
        gen = [np.asarray(tok)]
        for _ in range(new_tokens - 1):
            logits, cache = engine._decode(engine.params,
                                           tok[:, None].astype(jnp.int32),
                                           pos, cache)
            tok = jnp.argmax(logits, -1)
            pos = pos + 1
            gen.append(np.asarray(tok))
        outs.extend(np.stack(gen, 1))
    return outs


def test_generates_requested_lengths_as_the_reference():
    ref, eng = engines()
    rng = np.random.default_rng(0)
    ps = [rng.integers(0, 128, 8).astype(np.int32) for _ in range(4)]
    outs = eng.generate([Request(prompt=p, max_new_tokens=n)
                         for p, n in zip(ps, (4, 7, 3, 5))])
    want = ref.generate([RefRequest(prompt=p, max_new_tokens=n)
                         for p, n in zip(ps, (4, 7, 3, 5))])
    assert [len(o) for o in outs] == [4, 7, 3, 5]
    for o, w in zip(outs, want):
        assert np.all((o >= 0) & (o < 128))
        np.testing.assert_array_equal(o, w)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_greedy_equals_reference_token_for_token(arch):
    """Five ragged requests on batches of 2 (right-padded prompts, codebook
    rows and image embeddings included), 6 new tokens each."""
    ref, eng = engines(arch, B=2, cache_len=64)
    cfg = eng.model.cfg
    ps = prompts(cfg, 5, seed=11)
    outs = eng.generate([Request(prompt=p, max_new_tokens=6, img_embeds=i)
                         for p, i in ps])
    if cfg.num_image_tokens:
        want = ref_greedy_vlm(ref, ps, 6)
    else:
        want = ref.generate([RefRequest(prompt=p, max_new_tokens=6)
                             for p, _ in ps])
    for o, w in zip(outs, want):
        assert o.shape == ((6, cfg.num_codebooks) if cfg.num_codebooks
                           else (6,))
        np.testing.assert_array_equal(o, w)


def test_vlm_requests_need_image_embeddings():
    _, eng = engines("phi-3-vision-4.2b", B=2, cache_len=64)
    with pytest.raises(ValueError, match="img_embeds"):
        eng.generate([Request(prompt=np.arange(4, dtype=np.int32))])


def test_greedy_is_deterministic():
    _, eng = engines()
    prompt = np.random.default_rng(1).integers(0, 128, 8).astype(np.int32)
    r1 = eng.generate([Request(prompt=prompt, max_new_tokens=6)])
    r2 = eng.generate([Request(prompt=prompt, max_new_tokens=6)])
    np.testing.assert_array_equal(r1[0], r2[0])


def test_batch_slots_do_not_interfere():
    """Same-length prompts: a request's greedy output is identical whether
    served alone or alongside different requests, as in the reference."""
    ref, eng = engines(B=2)
    rng = np.random.default_rng(2)
    p1 = rng.integers(0, 128, 8).astype(np.int32)
    p2 = rng.integers(0, 128, 8).astype(np.int32)
    solo = eng.generate([Request(prompt=p1, max_new_tokens=5)])[0]
    both = eng.generate([Request(prompt=p1, max_new_tokens=5),
                         Request(prompt=p2, max_new_tokens=5)])
    np.testing.assert_array_equal(solo, both[0])
    want = ref.generate([RefRequest(prompt=p1, max_new_tokens=5),
                         RefRequest(prompt=p2, max_new_tokens=5)])
    for o, w in zip(both, want):
        np.testing.assert_array_equal(o, w)


def test_per_request_temperature():
    """A greedy (T=0) request stays greedy when batched with a sampled one
    and equals the reference's greedy row; the sampled row stays in the
    vocab; one seed repeats itself."""
    ref, eng = engines(B=2)
    rng = np.random.default_rng(3)
    p_greedy = rng.integers(0, 128, 8).astype(np.int32)
    p_hot = rng.integers(0, 128, 8).astype(np.int32)
    solo = eng.generate([Request(prompt=p_greedy, max_new_tokens=6)])[0]
    reqs = [Request(prompt=p_hot, max_new_tokens=6, temperature=5.0),
            Request(prompt=p_greedy, max_new_tokens=6)]
    mixed = eng.generate(reqs)
    np.testing.assert_array_equal(solo, mixed[1])
    assert np.all((mixed[0] >= 0) & (mixed[0] < 128))
    ref_mixed = ref.generate(
        [RefRequest(prompt=p_hot, max_new_tokens=6, temperature=5.0),
         RefRequest(prompt=p_greedy, max_new_tokens=6)])
    np.testing.assert_array_equal(ref_mixed[1], mixed[1])
    again = [ServeEngine(eng.model, eng.params, 2, 64, seed=s).generate(reqs)
             for s in (7, 7, 8)]
    np.testing.assert_array_equal(again[0][0], again[1][0])
    assert not np.array_equal(again[0][0], again[2][0])


def test_sampling_draws_from_the_tempered_softmax():
    """Sampled rows follow softmax(logits / T): 20,000 draws of 4 tokens
    at T = 2 within 0.015 of each probability; T <= 0 rows stay argmax."""
    _, eng = engines()
    logits = torch.tensor([[1.0, 0.0, -1.0, 2.0], [0.5, 3.0, 0.1, 0.2]])
    logits = logits.repeat(10_000, 1)
    temps = torch.tensor([2.0, 0.0]).repeat(10_000)
    draws = eng._sample(logits, temps, any_sampling=True)
    hot, cold = draws[0::2], draws[1::2]
    freq = torch.bincount(hot, minlength=4).float() / len(hot)
    want = torch.softmax(logits[0] / 2.0, -1)
    assert float((freq - want).abs().max()) < 0.015, (freq, want)
    assert torch.all(cold == 1)


def test_sampling_covers_codebook_rows():
    """Temperature sampling on (B, K, V) codebook logits: every row and
    codebook in the vocab, padded vocab entries never drawn."""
    _, eng = engines("musicgen-medium", B=2, cache_len=64)
    cfg = eng.model.cfg
    ps = prompts(cfg, 2, seed=4)
    outs = eng.generate([Request(prompt=p, max_new_tokens=5, temperature=1.5)
                         for p, _ in ps])
    for o in outs:
        assert o.shape == (5, cfg.num_codebooks)
        assert np.all((o >= 0) & (o < cfg.vocab_size))


RUN = """
import sys
from repro_torch.{module} import main
main({argv!r})
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))
assert not bad, bad
"""


def run_without_jax(module, argv):
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(module=module, argv=argv)],
        cwd=ROOT, capture_output=True, text=True, timeout=240,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "2"},
    )
    assert out.returncode == 0, out.stderr
    return out.stdout


LAUNCHER_CASES = [[a] for a in configs.ARCH_IDS] + [
    ["stablelm-1.6b", "--temperature", "0.8", "--quant", "q115"]]


@pytest.mark.parametrize("case", LAUNCHER_CASES, ids=" ".join)
def test_serve_launcher_lm_mode_on_cpu_without_jax(case):
    arch, *extra = case
    out = run_without_jax("launch.serve", [
        "--arch", arch, "--requests", "3", "--new-tokens", "4", "--batch",
        "2", "--device", "cpu", *extra])
    quant = "q115" if "--quant" in extra else "None"
    assert f"{arch}: served 3 reqs / 12 tokens in " in out, out
    assert f"tok/s on CPU, quant={quant})" in out, out


def test_serve_launcher_lm_needs_the_card_unless_told_cpu(monkeypatch):
    """The default mode is the LM; with no GPU and no --device it raises
    rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "mamba2-130m", "--requests", "1"])


def test_serve_launcher_flags_keep_the_reference_defaults(monkeypatch):
    from repro.launch import serve as ref_serve

    seen = []
    for mod in (serve, ref_serve):
        monkeypatch.setattr(mod, "_serve_lm",
                            lambda args: seen.append(vars(args)))
        mod.main([])
    port, ref = seen
    for key in ("arch", "reduced", "requests", "new_tokens", "batch",
                "cache_len", "temperature", "quant", "snn"):
        assert port[key] == ref[key], key
