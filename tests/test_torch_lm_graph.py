"""The LM ``ServeEngine``'s compiled prefill and decode: static buffers
(the cache of each batch size, the position, each signature's inputs),
one set-up a signature, CUDA graphs on the card.

On the CPU, which has no graphs, ``cuda_graph=True`` runs the same bodies
uncaptured over the same static buffers: held here bit for bit against
``cuda_graph=False`` (the eager engine) for the ten archs, and token for
token against the reference's engine for one arch a family.  The card
tests (``-m cuda``) hold the graph replays against the eager engine and
skip without a card:

    PYTHONPATH=src python -m pytest -q tests/test_torch_lm_graph.py
    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_lm_graph.py

Only the reference tests import JAX, inside the test, so the card tests
run where only the port is installed."""

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.configs as configs
from repro_torch.analysis.contracts import RecompileDetector
from repro_torch.launch.serve import lm_requests
from repro_torch.models.model import Model
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.tree import tree_flatten_with_names

# one arch a family: dense, moe, ssm, hybrid, vlm, audio
FAMILY_ARCHS = ["stablelm-1.6b", "mixtral-8x7b", "mamba2-130m",
                "recurrentgemma-2b", "phi-3-vision-4.2b", "musicgen-medium"]


def reduced(arch, **changes):
    cfg = configs.get(arch).reduced()
    return dataclasses.replace(cfg, **changes) if changes else cfg


def serve_recorded(engine, reqs):
    """(tokens, every logits tensor the engine sampled from, in order)."""
    seen = []
    sample = engine._sample

    def recording(logits, temps, any_sampling):
        seen.append(logits.clone())
        return sample(logits, temps, any_sampling)

    engine._sample = recording
    try:
        return engine.generate(reqs), seen
    finally:
        del engine._sample


def assert_same_run(got, want):
    (g_out, g_logits), (w_out, w_logits) = got, want
    assert len(g_out) == len(w_out)
    for g, w in zip(g_out, w_out):
        np.testing.assert_array_equal(g, w)
    assert len(g_logits) == len(w_logits)
    for i, (g, w) in enumerate(zip(g_logits, w_logits)):
        assert torch.equal(g, w), f"logits {i} differ"


def static_and_eager(cfg, dev, B, cache_len, seed=0):
    model = Model(cfg)
    params = model.init(0, dev)
    return (ServeEngine(model, params, B, cache_len, seed=seed),
            ServeEngine(model, params, B, cache_len, seed=seed,
                        cuda_graph=False))


def prompts_of(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    shape = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    return [rng.integers(0, cfg.vocab_size, (L, *shape)).astype(np.int32)
            for L in lengths]


# ------------------------------------------------ static buffers == eager
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_static_engine_equals_eager_bit_for_bit(arch):
    """Five ragged requests at batch 2 (a last batch of 1): tokens, the
    prefill logits and every decode step's logits equal the eager
    engine's, in a first serve (each signature's first run) and a second
    (the static inputs copied in)."""
    cfg = reduced(arch)
    static, eager = static_and_eager(cfg, "cpu", 2,
                                     48 + cfg.num_image_tokens)
    reqs = lm_requests(cfg, 5, 6, seed=1)
    want = serve_recorded(eager, reqs)
    assert_same_run(serve_recorded(static, reqs), want)
    assert_same_run(serve_recorded(static, reqs), want)
    assert sorted(static._states) == [1, 2]


def test_sampled_static_engine_equals_eager():
    """Per-row temperatures on one seed: the generator's draws happen
    outside the compiled steps, in the eager engine's order."""
    cfg = reduced("stablelm-1.6b", quant="q115")
    static, eager = static_and_eager(cfg, "cpu", 2, 48, seed=5)
    reqs = lm_requests(cfg, 3, 6, temperature=0.8, seed=2)
    reqs[1].temperature = 0.0
    assert_same_run(serve_recorded(static, reqs),
                    serve_recorded(eager, reqs))


# ---------------------------------------------------- against the reference
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_static_engine_equals_reference_engine(arch):
    """Served twice on the static buffers (the second serve over set-up
    signatures), the tokens equal the reference engine's, or, for the
    vlm, its jitted model's in the engine's loop (ROADMAP C10)."""
    from test_torch_lm_serving import engines, prompts, ref_greedy_vlm
    from repro.serving.engine import Request as RefRequest

    ref, port = engines(arch, B=2, cache_len=64)
    eng = ServeEngine(port.model, port.params, 2, 64, cuda_graph=True)
    cfg = eng.model.cfg
    ps = prompts(cfg, 3, seed=13)
    if cfg.num_image_tokens:
        want = ref_greedy_vlm(ref, ps, 5)
    else:
        want = ref.generate([RefRequest(prompt=p, max_new_tokens=5)
                             for p, _ in ps])
    for _ in range(2):
        outs = eng.generate([Request(prompt=p, max_new_tokens=5,
                                     img_embeds=i) for p, i in ps])
        for o, w in zip(outs, want):
            np.testing.assert_array_equal(o, w)
    assert eng._prefill._cache_size() >= 2 and eng._decode._cache_size() == 2


def test_a_batch_is_never_padded_to_the_engine_batch():
    """MoE groups a decode step's tokens by the batch: three requests on an
    engine of four run at B = 3 (a static cache and token of 3 rows), and
    equal the reference engine's tokens, which pads nothing either."""
    from test_torch_lm_serving import engines, prompts
    from repro.serving.engine import Request as RefRequest

    ref, port = engines("mixtral-8x7b", B=4, cache_len=64)
    eng = ServeEngine(port.model, port.params, 4, 64)
    ps = prompts(eng.model.cfg, 3, seed=17)
    outs = eng.generate([Request(prompt=p, max_new_tokens=5) for p, _ in ps])
    want = ref.generate([RefRequest(prompt=p, max_new_tokens=5)
                         for p, _ in ps])
    for o, w in zip(outs, want):
        np.testing.assert_array_equal(o, w)
    assert list(eng._states) == [3]
    assert [k for k in eng._decode.entries] == [(3,)]
    (entry,) = eng._decode.entries.values()
    assert entry["token"].shape == (3, 1)
    assert all(t.shape[1] == 3 for t in
               tree_flatten_with_names(eng._states[3]["cache"])[1])


# ------------------------------------------------------ the static cache
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_prefill_tree_has_init_caches_leaves(arch):
    cfg = reduced(arch)
    model = Model(cfg)
    params = model.init(0, "cpu")
    batch = {"tokens": torch.as_tensor(
        np.stack(prompts_of(cfg, (9, 9), seed=3)))}
    if cfg.num_image_tokens:
        batch["img_embeds"] = torch.zeros((2, cfg.num_image_tokens, 1024))
    cache_len = 40 + cfg.num_image_tokens
    with torch.no_grad():
        _, cache = model.prefill(params, batch, cache_len)
    names, got = tree_flatten_with_names(cache)
    want_names, want = tree_flatten_with_names(
        model.init_cache(2, cache_len, "cpu"))
    assert names == want_names
    for n, g, w in zip(names, got, want):
        assert (g.shape, g.dtype) == (w.shape, w.dtype), n


def test_a_prefill_tree_unlike_init_cache_raises_with_the_leaf():
    cfg = reduced("stablelm-1.6b")
    static, _ = static_and_eager(cfg, "cpu", 2, 32)
    st = static._state(2)
    leaf = st["cache"]["main"]["b0"]["k"]
    st["cache"]["main"]["b0"]["k"] = leaf.to(torch.float64)
    with pytest.raises(ValueError, match="main/b0/k"):
        static.generate(lm_requests(cfg, 2, 3, seed=4))
    assert static._prefill._cache_size() == 0


# ----------------------------------------------------------- set-up counts
def test_each_signature_is_set_up_once():
    """A second serve of the same shapes sets up nothing; a new Lmax one
    prefill; a ragged last batch one prefill and one decode (a new B);
    ``RecompileDetector.track`` reads the counts."""
    cfg = reduced("granite-moe-1b-a400m")
    eng, _ = static_and_eager(cfg, "cpu", 2, 40)

    def serve(lengths):
        eng.generate([Request(prompt=p, max_new_tokens=4)
                      for p in prompts_of(cfg, lengths, seed=len(lengths))])
        return eng._prefill._cache_size(), eng._decode._cache_size()

    with RecompileDetector() as det:
        det.track("prefill", eng._prefill, allowed=1)
        det.track("decode", eng._decode, allowed=1)
        assert serve((8, 5, 8, 8)) == (1, 1)  # two batches, Lmax 8
    assert det.unexpected() == [] and det.backend_compiles == 2
    with RecompileDetector() as det:
        det.track("prefill", eng._prefill)
        det.track("decode", eng._decode)
        assert serve((8, 5, 8, 8)) == (1, 1)
    assert det.unexpected() == [] and det.backend_compiles == 0
    with RecompileDetector() as det:
        det.track("decode", eng._decode)
        assert serve((11, 3)) == (2, 1)  # a new Lmax
        assert serve((8, 8, 6)) == (3, 2)  # a last batch of 1
    assert det.report()["tracked"]["decode"] == {
        "cache_growth": 1, "allowed": 0, "unexpected": 1}
    assert len(det.unexpected()) == 1 and det.backend_compiles == 3
    assert eng._decode.replays == eng._prefill.replays == 0  # the CPU


def test_the_cpu_captures_nothing_and_keeps_its_buffers():
    cfg = reduced("mamba2-130m")
    eng, _ = static_and_eager(cfg, "cpu", 2, 40)
    reqs = lm_requests(cfg, 2, 4, seed=6)
    eng.generate(reqs)
    ptrs = [t.data_ptr() for t in tree_flatten_with_names(
        eng._states[2])[1]]
    eng.generate(reqs)
    assert [t.data_ptr() for t in tree_flatten_with_names(
        eng._states[2])[1]] == ptrs
    assert not eng.graphed and eng._pool is None
    assert all(e["graph"] is None for e in eng._decode.entries.values())
    assert eng._prefill.capture_s == eng._decode.capture_s == []


def test_a_dropped_engine_is_freed_at_once():
    """No reference cycle holds an engine: dropped, it goes (with its
    graphs, on the card) without waiting for a garbage collection."""
    import gc
    import weakref

    cfg = reduced("stablelm-1.6b")
    eng, _ = static_and_eager(cfg, "cpu", 2, 32)
    eng.generate(lm_requests(cfg, 2, 3, seed=10))
    ref = weakref.ref(eng)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        if collecting:
            gc.enable()


@pytest.mark.parametrize("enabled", [True, False])
def test_no_collection_holds_the_collector_off_and_restores_it(enabled):
    """Every capture site runs under ``contracts.no_collection``: no
    collection inside it, even on a raise, and the collector's state as
    it was after."""
    import gc

    from repro_torch.analysis import contracts

    was = gc.isenabled()
    (gc.enable if enabled else gc.disable)()
    try:
        with pytest.raises(RuntimeError, match="capture failed"):
            with contracts.no_collection():
                assert not gc.isenabled()
                raise RuntimeError("capture failed")
        assert gc.isenabled() is enabled
    finally:
        (gc.enable if was else gc.disable)()


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs are captured on the "
                    "card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


CARD_CASES = {
    "mamba2-130m": ("mamba2-130m", {}),
    "recurrentgemma-2b": ("recurrentgemma-2b", {}),
    "stablelm-int8-kv": ("stablelm-1.6b", {"kv_cache_quant": True}),
    "stablelm-q115": ("stablelm-1.6b", {"quant": "q115"}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_graphed_equals_eager_on_card(cuda_device, case):
    """Three requests at batch 2, 9 new tokens (8 decode steps): a cold
    serve (each signature's real run, then its capture) and a warm one
    (replays only) equal the eager engine bit for bit, tokens and logits.
    A warm-up that advanced the recurrent state (the SSD state, the conv
    windows, the RG-LRU ``h``) would break the first."""
    arch, changes = CARD_CASES[case]
    cfg = reduced(arch, **changes)
    graphed, eager = static_and_eager(cfg, cuda_device, 2, 48)
    reqs = lm_requests(cfg, 3, 9, seed=7)
    want = serve_recorded(eager, reqs)
    assert_same_run(serve_recorded(graphed, reqs), want)
    sizes = (graphed._prefill._cache_size(), graphed._decode._cache_size())
    assert sizes == (2, 2)  # B = 2 and the last batch's B = 1
    assert len(graphed._prefill.capture_s + graphed._decode.capture_s) == 4
    replays = graphed._decode.replays
    assert replays == 2 * 7  # each batch: 8 steps, the first one its run
    assert_same_run(serve_recorded(graphed, reqs), want)
    assert graphed._decode.replays == replays + 2 * 8
    assert graphed._prefill.replays == 2
    assert sizes == (graphed._prefill._cache_size(),
                     graphed._decode._cache_size())


@pytest.mark.cuda
def test_failed_lm_capture_raises_on_card(cuda_device, monkeypatch):
    """A decode body that reads the card from the host cannot be captured:
    the serve raises, and no eager step runs in the graph's place."""
    cfg = reduced("stablelm-1.6b")
    eng, _ = static_and_eager(cfg, cuda_device, 2, 32)
    real = eng._decode_body
    calls = []

    def reading_body(token, pos, cache):
        calls.append(1)
        logits = real(token, pos, cache)
        logits.sum().item()  # a host read: illegal while capturing
        return logits

    monkeypatch.setattr(eng, "_decode_body", reading_body)
    with pytest.raises(RuntimeError):
        eng.generate(lm_requests(cfg, 2, 5, seed=8))
    torch.cuda.synchronize()
    assert len(calls) == 2  # the first run, then the capture that failed
    assert eng._decode._cache_size() == 0 and eng._decode.replays == 0


@pytest.mark.cuda
def test_lm_replay_step_reads_nothing_back_on_card(cuda_device):
    cfg = reduced("recurrentgemma-2b")
    eng, _ = static_and_eager(cfg, cuda_device, 2, 32)
    reqs = lm_requests(cfg, 2, 4, seed=9)
    eng.generate(reqs)  # captures
    Lmax = max(len(r.prompt) for r in reqs)
    tokens = np.stack([np.pad(r.prompt, (0, Lmax - len(r.prompt)))
                       for r in reqs])
    with torch.no_grad():
        logits = eng._prefill({"tokens": torch.as_tensor(tokens).to(
            cuda_device)})
        tok = logits.argmax(-1)
        before = eng._decode.replays
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            tok = eng._decode(tok).argmax(-1)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    assert eng._decode.replays == before + 1
    assert tok.shape == (2,)


@pytest.mark.cuda
def test_a_collection_during_a_capture_cannot_void_it_on_card(cuda_device,
                                                              monkeypatch):
    """A graphed engine becomes cyclic garbage inside another engine's
    decode capture, while the collector would run at every allocation:
    the capture still succeeds (nothing is collected inside a capture,
    where a graph's teardown is an illegal call), and the old engine is
    collected after it."""
    import gc
    import weakref

    cfg = reduced("mamba2-130m")
    reqs = lm_requests(cfg, 2, 4, seed=11)
    old, _ = static_and_eager(cfg, cuda_device, 2, 32)
    old.generate(reqs)
    old.cycle = old  # collectable only by the garbage collector
    gone = weakref.ref(old)
    holder = [old]
    del old
    graphed, eager = static_and_eager(cfg, cuda_device, 2, 32)
    real = graphed._decode_body
    calls = []

    def body(token, pos, cache):
        calls.append(1)
        if len(calls) == 2:  # inside the capture
            holder.clear()
            [[] for _ in range(1000)]  # the collector's trigger
        return real(token, pos, cache)

    monkeypatch.setattr(graphed, "_decode_body", body)
    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        got = graphed.generate(reqs)
    finally:
        gc.set_threshold(*thresholds)
    for g, w in zip(got, eager.generate(reqs)):
        np.testing.assert_array_equal(g, w)
    assert len(calls) == 2 and graphed._decode.replays == 2
    gc.collect()
    assert gone() is None
