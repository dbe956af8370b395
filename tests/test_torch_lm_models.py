"""The port's LM zoo (``repro_torch.models``) against the reference's
(``repro.models``) on the CPU: the ten archs at ``reduced()`` size, the
reference's params carried over by ``params_from_numpy``, the same numpy
tokens (and image embeddings) from a seed.  Teacher-forced logits,
``prefill`` logits and cache leaves and each ``decode_step``'s logits and
cache agree within atol = rtol = 1e-4; integer leaves are bit-exact.  The
reference's own LM cases (attention, MoE, SSM, RG-LRU, decode
consistency, the zoo's configs and parameter counts) are ported against
the port."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.models import attention as ref_attention
from repro.models import moe as ref_moe
from repro.models import ssm as ref_ssm
from repro.models.model import CLIP_EMBED_DIM
from repro.models.model import Model as RefModel
import repro_torch.configs as configs
from repro_torch.models import attention, griffin, moe, ssm, transformer
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import Init
from repro_torch.models.model import Model, params_from_numpy
from repro_torch.tree import tree_flatten_with_names

TOL = dict(rtol=1e-4, atol=1e-4)
B, L, LP = 2, 20, 16  # batch, tokens, prompt tokens before decoding
DECODE_ARCHS = [
    "stablelm-1.6b",       # dense MHA + partial rope + layernorm + bias
    "mixtral-8x7b",        # MoE + SWA ring cache
    "minicpm3-4b",         # MLA compressed cache
    "mamba2-130m",         # SSM recurrent cache
    "recurrentgemma-2b",   # hybrid RG-LRU + local attn
    "musicgen-medium",     # codebooks + sinusoidal PE
]


def t(x):
    return torch.as_tensor(np.array(x))


def port_cfg(ref_cfg):
    return ModelConfig(**dataclasses.asdict(ref_cfg))


def ref_reduced(arch, **overrides):
    """The reduced reference config; a MoE config merged with
    capacity_factor=100, moe_group_size=16, as the reference's decode
    consistency test does (no token is dropped, whatever the grouping)."""
    cfg = ref_configs.get(arch).reduced()
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=100.0,
                                  moe_group_size=16)
    return dataclasses.replace(cfg, **overrides)


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def pair(ref_cfg, seed=1):
    """(reference model, its params, port model, the same params)."""
    rm = RefModel(ref_cfg)
    rp, _ = rm.init(jax.random.PRNGKey(seed))
    cfg = port_cfg(ref_cfg)
    return rm, rp, Model(cfg), params_from_numpy(np_tree(rp), cfg, "cpu")


def batch_np(cfg, seed=1, length=L):
    rng = np.random.default_rng(seed)
    shape = (B, length, cfg.num_codebooks) if cfg.num_codebooks else (B, length)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.num_image_tokens:
        batch["img_embeds"] = rng.normal(
            0, 1, (B, cfg.num_image_tokens, CLIP_EMBED_DIM)).astype(np.float32)
    return batch


def assert_tree_close(ref_tree, port_tree, code_flips=0.0):
    """Float leaves within TOL, integer leaves bit-exact.  ``code_flips``
    admits that share of int8 KV codes off by one: codes quantized from
    keys and values that the two packages compute in float32 in another
    order (ROADMAP C9)."""
    rn, rl = tree_flatten_with_names(np_tree(ref_tree))
    pn, pl = tree_flatten_with_names(port_tree)
    assert rn == pn
    for name, a, b in zip(rn, rl, pl):
        b = b.detach().cpu().numpy()
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        if a.dtype == np.int8 and code_flips:
            off = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert off.max() <= 1, name
            assert off.sum() <= code_flips * off.size, (name, off.sum())
        elif np.issubdtype(a.dtype, np.integer):
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, err_msg=name, **TOL)


def _ref_forward(rm, rp, batch):
    """Teacher-forced logits, on the params the quant mode serves (the
    reference's ``loss`` and ``prefill`` apply ``_maybe_quant`` first)."""
    rp = rm._maybe_quant(rp)
    x = rm._inputs(rp, batch)
    b, n = x.shape[0], x.shape[1]
    pos = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32), (b, n))
    h, _ = rm.backbone(rp, x, pos)
    if rm.cfg.num_image_tokens:
        h = h[:, rm.cfg.num_image_tokens:]
    return rm._head(rp, h)


@functools.lru_cache(maxsize=None)
def zoo_case(arch, overrides=()):
    """The reference's and the port's forward, prefill and decode on one
    arch: (port model, port params, batch, reference results).  The
    reference's steps are jitted; its caches are kept as numpy."""
    rcfg = ref_reduced(arch, **dict(overrides))
    rm, rp, pm, pp = pair(rcfg)
    batch = batch_np(rcfg)
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    pre = dict(rb, tokens=rb["tokens"][:, :LP])
    cache_len = L + rcfg.num_image_tokens + 8
    ref = {"forward": np.asarray(jax.jit(_ref_forward, static_argnums=0)(
        rm, rp, rb))}
    logits, cache = jax.jit(rm.prefill, static_argnums=2)(rp, pre, cache_len)
    ref["prefill"] = (np.asarray(logits), np_tree(cache))
    decode = jax.jit(rm.decode_step)
    steps = []
    for s in range(LP, L):
        pos = jnp.full((B,), s + rcfg.num_image_tokens, jnp.int32)
        logits, cache = decode(rp, rb["tokens"][:, s: s + 1], pos, cache)
        steps.append((np.asarray(logits), np_tree(cache)))
    ref["decode"] = steps
    return pm, pp, batch, cache_len, ref


def port_batch(batch, length=None):
    out = {k: t(v) for k, v in batch.items()}
    if length is not None:
        out["tokens"] = out["tokens"][:, :length]
    return out


# ============================================================ the zoo
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_forward_logits_match_reference(arch):
    pm, pp, batch, _, ref = zoo_case(arch)
    got = pm.forward_logits(pp, port_batch(batch))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(ref["forward"], got.numpy(), **TOL)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_prefill_logits_and_cache_match_reference(arch):
    pm, pp, batch, cache_len, ref = zoo_case(arch)
    logits, cache = pm.prefill(pp, port_batch(batch, LP), cache_len)
    np.testing.assert_allclose(ref["prefill"][0], logits.numpy(), **TOL)
    assert_tree_close(ref["prefill"][1], cache)


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_decode_steps_logits_and_cache_match_reference(arch):
    pm, pp, batch, cache_len, ref = zoo_case(arch)
    tokens = t(batch["tokens"])
    _, cache = pm.prefill(pp, port_batch(batch, LP), cache_len)
    for s, (ref_logits, ref_cache) in zip(range(LP, L), ref["decode"]):
        pos = torch.full((B,), s + pm.cfg.num_image_tokens)
        logits, cache = pm.decode_step(pp, tokens[:, s: s + 1], pos, cache)
        np.testing.assert_allclose(ref_logits, logits.numpy(), **TOL)
        assert_tree_close(ref_cache, cache)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_prefill_decode_matches_own_forward(arch):
    """Prefill + step decode reproduces the port's own teacher-forced
    logits (the reference's test_decode_consistency)."""
    pm, pp, batch, cache_len, _ = zoo_case(arch)
    full = pm.forward_logits(pp, port_batch(batch)).numpy()
    logits, cache = pm.prefill(pp, port_batch(batch, LP), cache_len)
    errs = [np.max(np.abs(logits.numpy() - full[:, LP - 1]))]
    tokens = t(batch["tokens"])
    for s in range(LP, L):
        pos = torch.full((B,), s + pm.cfg.num_image_tokens)
        logits, cache = pm.decode_step(pp, tokens[:, s: s + 1], pos, cache)
        errs.append(np.max(np.abs(logits.numpy() - full[:, s])))
    assert max(errs) < 5e-4, (arch, errs)


QUANT_MODES = [("quant", "q115"), ("quant", "q1_7"), ("quant", "q115_int"),
               ("quant", "q1_7_int"), ("kv_cache_quant", True)]


@pytest.mark.parametrize("mode", QUANT_MODES, ids=lambda m: f"{m[0]}={m[1]}")
def test_quant_modes_match_reference(mode):
    """stablelm-1.6b reduced in each serving quant mode: logits of the
    forward, prefill and every decode step, and the cache against the
    reference's.  The int8 KV codes agree but for at most 0.05 % off by one
    (their quantizer is bit-exact on equal keys: the next test)."""
    pm, pp, batch, cache_len, ref = zoo_case("stablelm-1.6b", (mode,))
    flips = 5e-4 if mode[0] == "kv_cache_quant" else 0.0
    got = pm.forward_logits(pp, port_batch(batch))
    np.testing.assert_allclose(ref["forward"], got.numpy(), **TOL)
    logits, cache = pm.prefill(pp, port_batch(batch, LP), cache_len)
    np.testing.assert_allclose(ref["prefill"][0], logits.numpy(), **TOL)
    assert_tree_close(ref["prefill"][1], cache, flips)
    tokens = t(batch["tokens"])
    for s, (ref_logits, ref_cache) in zip(range(LP, L), ref["decode"]):
        logits, cache = pm.decode_step(pp, tokens[:, s: s + 1],
                                       torch.full((B,), s), cache)
        np.testing.assert_allclose(ref_logits, logits.numpy(), **TOL)
        assert_tree_close(ref_cache, cache, flips)


def test_kv_cache_codes_bit_exact_on_the_reference_keys():
    """The port's int8 KV quantizer, fed the reference's own float keys and
    values (its unquantized prefill cache), gives the reference's int8
    prefill cache codes and scales bit for bit, every layer."""
    rcfg = ref_reduced("stablelm-1.6b")
    rm, rp, _, _ = pair(rcfg)
    tokens = jnp.asarray(batch_np(rcfg)["tokens"][:, :LP])
    _, plain = rm.prefill(rp, {"tokens": tokens}, LP)
    qm = RefModel(dataclasses.replace(rcfg, kv_cache_quant=True))
    _, coded = qm.prefill(rp, {"tokens": tokens}, LP)
    for name in ("k", "v"):
        codes, scale = attention.kv_quantize(t(plain["main"]["b0"][name]))
        np.testing.assert_array_equal(
            np.asarray(coded["main"]["b0"][name]), codes.numpy())
        np.testing.assert_array_equal(
            np.asarray(coded["main"]["b0"][f"{name}_scale"]), scale.numpy())


@pytest.mark.parametrize("quant", ["q115_int", "q1_7_int"])
def test_int_storage_codes_bit_exact(quant):
    """The port's true-int storage of the same float params gives the
    reference's int16 / int8 codes bit for bit, norms included where
    their layer-stacked shape has two dims."""
    rcfg = ref_reduced("stablelm-1.6b")
    rm, rp, pm, pp = pair(rcfg)
    want = RefModel(dataclasses.replace(rcfg, quant=quant))._quantize_storage(rp)
    got = Model(port_cfg(dataclasses.replace(rcfg, quant=quant)))._quantize_storage(pp)
    names, leaves = tree_flatten_with_names(got)
    ints = [n for n, x in zip(names, leaves) if not x.is_floating_point()]
    assert "main/b0/norm1/scale" in ints and "final_norm/scale" not in ints
    assert_tree_close(want, got)


def test_decode_past_cache_end_drops_the_write_as_the_reference():
    """A position past the full cache's end: the reference's scatter drops
    the write, and the step attends over the cache it has."""
    rcfg = ref_reduced("stablelm-1.6b")
    rm, rp, pm, pp = pair(rcfg)
    batch = batch_np(rcfg)
    rb = {"tokens": jnp.asarray(batch["tokens"][:, :LP])}
    _, rc = rm.prefill(rp, rb, LP)
    _, pc = pm.prefill(pp, port_batch(batch, LP), LP)
    tok = batch["tokens"][:, LP: LP + 1]
    pos = np.array([LP - 1, LP], np.int32)  # row 1 is past the end
    rl, rc = rm.decode_step(rp, jnp.asarray(tok), jnp.asarray(pos), rc)
    pl, pc = pm.decode_step(pp, t(tok), t(pos).long(), pc)
    np.testing.assert_allclose(np.asarray(rl), pl.numpy(), **TOL)
    assert_tree_close(rc, pc)


# ============================================================ configs
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_arch_full_config_matches_reference(arch):
    """The full configs carry the reference's published numbers, field for
    field (which covers the reference's spot checks)."""
    assert dataclasses.asdict(configs.get(arch)) == dataclasses.asdict(
        ref_configs.get(arch))
    assert configs.get(arch).reduced() == port_cfg(ref_configs.get(arch).reduced())


def test_registry_errors_match_reference():
    with pytest.raises(ValueError, match="collision-snn is an SNNConfig"):
        configs.get("collision-snn")
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get("gpt-5")
    assert list(configs.all_configs()) == ref_configs.ARCH_IDS


@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_param_counts_equal_reference_without_allocation(arch):
    cfg = configs.get(arch)
    model = Model(cfg)
    assert all(x.device.type == "meta"
               for x in tree_flatten_with_names(model.abstract())[1])
    ref = RefModel(ref_configs.get(arch))
    assert model.param_count() == ref.param_count()
    assert model.active_param_count() == ref.active_param_count()


def test_param_counts_in_right_ballpark():
    expect = {
        "mixtral-8x7b": (45e9, 48e9),
        "yi-34b": (33e9, 36e9),
        "mamba2-130m": (0.1e9, 0.2e9),
        "stablelm-1.6b": (1.4e9, 1.9e9),
        "musicgen-medium": (1.3e9, 2.2e9),
    }
    for arch, (lo, hi) in expect.items():
        n = Model(configs.get(arch)).param_count()
        assert lo < n < hi, (arch, n)
    assert Model(configs.get("stablelm-1.6b")).param_count() == 1_644_515_328


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "musicgen-medium",
                                  "recurrentgemma-2b"])
def test_init_tree_and_distributions(arch):
    """``init`` gives the reference's tree (names, shapes, dtypes) from the
    port's own generator: seeded, fan-in-scaled uniforms, 0.02 normals."""
    cfg = configs.get(arch).reduced()
    p1 = Model(cfg).init(3, "cpu")
    p2 = Model(cfg).init(3, "cpu")
    rp, _ = RefModel(ref_configs.get(arch).reduced()).init(jax.random.PRNGKey(0))
    params_from_numpy(np_tree(rp), cfg, "cpu")  # same structure
    names, leaves = tree_flatten_with_names(p1)
    for n, a, b in zip(names, leaves, tree_flatten_with_names(p2)[1]):
        assert torch.equal(a, b), n
    table = p1["embed"]["table"]
    assert abs(float(table.std()) - 0.02) < 2e-3
    w = p1["final_norm"]["scale"]
    assert torch.equal(w, torch.ones_like(w))
    up = p1["main"]["b0"]["ffn"]["w_up"]
    bound = 1.0 / np.sqrt(cfg.d_model)
    assert float(up.abs().max()) <= bound and float(up.abs().max()) > 0.9 * bound


def test_params_from_numpy_refuses_another_tree():
    rcfg = ref_reduced("stablelm-1.6b")
    rp, _ = RefModel(rcfg).init(jax.random.PRNGKey(0))
    tree = np_tree(rp)
    tree.pop("lm_head")
    with pytest.raises(ValueError, match="lm_head"):
        params_from_numpy(tree, port_cfg(rcfg), "cpu")


# ============================================================ attention
RNG = np.random.default_rng(7)


def _qkv(Bq=2, Lq=16, Lk=16, Kv=2, G=2, D=8):
    q = RNG.normal(0, 1, (Bq, Lq, Kv, G, D)).astype(np.float32)
    k = RNG.normal(0, 1, (Bq, Lk, Kv, D)).astype(np.float32)
    v = RNG.normal(0, 1, (Bq, Lk, Kv, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Lq), (Bq, Lq)).copy()
    kpos = np.broadcast_to(np.arange(Lk), (Bq, Lk)).copy()
    return q, k, v, pos, kpos


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("chunk", [3, 8, 16, 64])
def test_chunked_equals_full_and_reference(window, chunk):
    q, k, v, pos, kpos = _qkv()
    full = attention.attend_full(t(q), t(k), t(v), t(pos), t(kpos),
                                 window=window, scale=0.35)
    chunked = attention.attend_chunked(t(q), t(k), t(v), t(pos), t(kpos),
                                       window=window, scale=0.35, chunk=chunk)
    np.testing.assert_allclose(full.numpy(), chunked.numpy(), rtol=2e-5,
                               atol=2e-5)
    ref = ref_attention.attend_chunked(q, k, v, pos, kpos, window=window,
                                       scale=0.35, chunk=chunk)
    np.testing.assert_allclose(np.asarray(ref), chunked.numpy(), **TOL)


def test_auto_picks_chunked_at_8192_keys(monkeypatch):
    cfg = ModelConfig(num_heads=2, num_kv_heads=1, head_dim=4, d_model=8,
                      attn_chunk=4096, dtype="float32")
    calls = []
    orig = attention.attend_chunked

    def spy(*a, **kw):
        calls.append(kw)
        return orig(*a, **kw)

    monkeypatch.setattr(attention, "attend_chunked", spy)
    for lk in (8191, 8192):
        q = torch.zeros((1, 1, 1, 2, 4))
        k = torch.zeros((1, lk, 1, 4))
        attention._attend(q, k, k, torch.zeros((1, 1), dtype=torch.long),
                          torch.arange(lk)[None], cfg, 0.5)
    assert len(calls) == 1 and calls[0]["chunk"] == 4096


def test_causal_mask_no_future_leak():
    q, k, v, pos, kpos = _qkv(Lq=8, Lk=8)
    out1 = attention.attend_full(t(q), t(k), t(v), t(pos), t(kpos),
                                 window=None, scale=1.0)
    k2, v2 = k.copy(), v.copy()
    k2[:, 5:] = 99.0
    v2[:, 5:] = -99.0
    out2 = attention.attend_full(t(q), t(k2), t(v2), t(pos), t(kpos),
                                 window=None, scale=1.0)
    np.testing.assert_allclose(out1[:, :5].numpy(), out2[:, :5].numpy(),
                               rtol=1e-6)


def test_sliding_window_ignores_old_tokens():
    q, k, v, pos, kpos = _qkv(Lq=10, Lk=10)
    out1 = attention.attend_full(t(q), t(k), t(v), t(pos), t(kpos),
                                 window=3, scale=1.0)
    k2, v2 = k.copy(), v.copy()
    k2[:, :3] = 50.0
    v2[:, :3] = -50.0
    out2 = attention.attend_full(t(q), t(k2), t(v2), t(pos), t(kpos),
                                 window=3, scale=1.0)
    np.testing.assert_allclose(out1[:, -1].numpy(), out2[:, -1].numpy(),
                               rtol=1e-6)


def _swa_cfg(window):
    return dict(num_layers=1, d_model=32, num_heads=4, num_kv_heads=2,
                head_dim=8, d_ff=64, vocab_size=64, attention_kind="swa",
                window=window, dtype="float32")


def _init_np(init_fn, cfg, seed=0):
    """Params of one reference init function as numpy."""
    return np_tree(init_fn(jax.random.PRNGKey(seed), cfg)[0])


def test_ring_cache_decode_matches_full_forward_and_reference():
    """Ring-buffer (window) decode == teacher-forced SWA attention; the ring
    cache equals the reference's after every step."""
    from repro.models.config import ModelConfig as RefConfig

    rcfg = RefConfig(**_swa_cfg(window=4))
    cfg = ModelConfig(**_swa_cfg(window=4))
    pn = _init_np(ref_attention.gqa_init, rcfg)
    p = {k: t(v) for k, v in pn.items()}
    Lx = 12
    x = RNG.normal(0, 0.5, (B, Lx, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Lx), (B, Lx)).copy()
    full = attention.gqa_forward(p, t(x), t(pos), cfg)
    np.testing.assert_allclose(
        np.asarray(ref_attention.gqa_forward(pn, x, pos, rcfg)), full.numpy(),
        **TOL)
    Lp = 6
    _, cache = attention.gqa_prefill(p, t(x[:, :Lp]), t(pos[:, :Lp]), cfg, Lx)
    _, rcache = ref_attention.gqa_prefill(pn, x[:, :Lp], pos[:, :Lp], rcfg, Lx)
    assert cache["k"].shape[1] == 4
    outs = []
    for s in range(Lp, Lx):
        o, cache = attention.gqa_decode(p, t(x[:, s: s + 1]),
                                        torch.full((B,), s), cache, cfg)
        _, rcache = ref_attention.gqa_decode(
            pn, x[:, s: s + 1], jnp.full((B,), s, jnp.int32), rcache, rcfg)
        assert_tree_close(rcache, cache)
        outs.append(o)
    np.testing.assert_allclose(full[:, Lp:].numpy(),
                               torch.cat(outs, dim=1).numpy(),
                               rtol=2e-4, atol=2e-4)


MLA_CFG = dict(num_layers=1, d_model=64, num_heads=4, num_kv_heads=4,
               d_ff=64, vocab_size=64, mla=True, q_lora_rank=32,
               kv_lora_rank=16, qk_nope_head_dim=8, qk_rope_head_dim=4,
               v_head_dim=8, dtype="float32", head_dim=12)


@pytest.mark.parametrize("absorb", [False, True])
def test_mla_absorbed_equals_naive_and_reference(absorb):
    from repro.models.config import ModelConfig as RefConfig

    rcfg, cfg = RefConfig(**MLA_CFG), ModelConfig(**MLA_CFG)
    pn = _init_np(ref_attention.mla_init, rcfg)
    p = {k: t(v) for k, v in pn.items()}
    Lx = 10
    x = RNG.normal(0, 0.5, (B, Lx, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(Lx), (B, Lx)).copy()
    naive = attention.mla_forward(p, t(x), t(pos), cfg, absorb=False)
    got = attention.mla_forward(p, t(x), t(pos), cfg, absorb=absorb)
    np.testing.assert_allclose(naive.numpy(), got.numpy(), rtol=2e-4,
                               atol=2e-4)
    ref = ref_attention.mla_forward(pn, x, pos, rcfg, absorb=absorb)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), **TOL)


def test_kv_quantize_codes_bit_exact():
    x = RNG.normal(0, 2.0, (2, 5, 3, 16)).astype(np.float32)
    codes, scale = attention.kv_quantize(t(x))
    rc, rs = ref_attention.kv_quantize(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(rc), codes.numpy())
    np.testing.assert_array_equal(np.asarray(rs), scale.numpy())
    np.testing.assert_allclose(
        np.asarray(ref_attention.kv_dequantize(rc, rs)),
        attention.kv_dequantize(codes, scale).numpy(), rtol=0, atol=0)


# ============================================================ MoE
def _moe_cfg(**kw):
    base = dict(num_layers=1, d_model=32, num_heads=2, num_kv_heads=2,
                d_ff=16, vocab_size=64, num_experts=4, num_experts_per_tok=2,
                capacity_factor=1000.0, moe_group_size=8, dtype="float32",
                mlp_kind="swiglu")
    base.update(kw)
    return base


def _moe_params(**kw):
    from repro.models.config import ModelConfig as RefConfig

    rcfg = RefConfig(**_moe_cfg(**kw))
    pn = _init_np(ref_moe.moe_init, rcfg)
    return rcfg, ModelConfig(**_moe_cfg(**kw)), pn, {k: t(v) for k, v in pn.items()}


def _dense_moe(p, x, cfg):
    """Loop-over-experts oracle (no capacity, exact top-k combine)."""
    xs = x.reshape(-1, x.shape[-1])
    w, idx = moe.router_weights(t(xs) @ p["router"], cfg)
    out = np.zeros_like(xs)
    for s in range(xs.shape[0]):
        for j in range(cfg.num_experts_per_tok):
            e = int(idx[s, j])
            up = xs[s] @ p["w_up"][e].numpy()
            gate = xs[s] @ p["w_gate"][e].numpy()
            h = (gate / (1 + np.exp(-gate))) * up
            out[s] += float(w[s, j]) * (h @ p["w_down"][e].numpy())
    return out.reshape(x.shape)


@pytest.mark.parametrize("order", ["topk_then_softmax", "softmax_then_topk"])
def test_moe_matches_dense_oracle_and_reference(order):
    rcfg, cfg, pn, p = _moe_params(router_softmax_order=order)
    x = RNG.normal(0, 0.5, (2, 8, 32)).astype(np.float32)
    got, aux = moe.moe_forward(p, t(x), cfg)
    np.testing.assert_allclose(got.numpy(), _dense_moe(p, x, cfg),
                               rtol=2e-4, atol=2e-4)
    assert float(aux["moe_dropped_frac"]) == 0.0
    ref, ref_aux = ref_moe.moe_forward(pn, x, rcfg)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), **TOL)
    np.testing.assert_allclose(float(ref_aux["moe_aux_loss"]),
                               float(aux["moe_aux_loss"]), **TOL)


@pytest.mark.parametrize("cf", [0.25, 0.5, 1.0, 2.0])
def test_capacity_drops_match_reference(cf):
    """Overflow tokens are dropped as the reference drops them: same
    outputs, aux loss and dropped fraction at every capacity."""
    rcfg, cfg, pn, p = _moe_params(capacity_factor=cf)
    x = RNG.normal(0, 0.5, (2, 16, 32)).astype(np.float32)
    got, aux = moe.moe_forward(p, t(x), cfg)
    ref, ref_aux = ref_moe.moe_forward(pn, x, rcfg)
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), **TOL)
    for key in ("moe_aux_loss", "moe_dropped_frac"):
        np.testing.assert_allclose(float(ref_aux[key]), float(aux[key]), **TOL)
    if cf == 0.25:
        assert float(aux["moe_dropped_frac"]) > 0.0


def test_dropped_frac_monotone_in_capacity():
    _, _, _, p = _moe_params()
    x = t(RNG.normal(0, 0.5, (2, 16, 32)).astype(np.float32))
    drops = [float(moe.moe_forward(p, x, ModelConfig(**_moe_cfg(
        capacity_factor=cf)))[1]["moe_dropped_frac"])
        for cf in (0.25, 0.5, 1.0, 2.0)]
    assert all(a >= b - 1e-9 for a, b in zip(drops, drops[1:]))


def test_group_size_and_capacity_match_reference():
    from repro.models.config import ModelConfig as RefConfig

    for kw, tokens in (({}, 24), ({}, 7), ({"moe_group_size": 512}, 128),
                       ({"moe_group_size": 16}, 40)):
        cfg, rcfg = ModelConfig(**_moe_cfg(**kw)), RefConfig(**_moe_cfg(**kw))
        gs = moe.group_size(cfg, tokens)
        assert gs == ref_moe.group_size(rcfg, tokens)
        assert moe.capacity(gs, cfg) == ref_moe.capacity(gs, rcfg)
    assert moe.group_size(ModelConfig(**_moe_cfg()), 24) == 8


def test_aux_loss_uniform_router_is_one():
    _, cfg, _, p = _moe_params(num_experts_per_tok=1)
    p = dict(p, router=torch.zeros_like(p["router"]))
    x = t(RNG.normal(0, 0.5, (4, 8, 32)).astype(np.float32))
    _, aux = moe.moe_forward(p, x, cfg)
    assert 0.5 < float(aux["moe_aux_loss"]) < 2.0


# ============================================================ SSM
def _sequential_ssd(xdt, dA, Bm, Cm):
    """Per-step recurrence oracle: h = exp(dA)*h + B*xdt; y = C.h"""
    Bb, Lx, H, P = xdt.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    h = np.zeros((Bb, H, P, N), np.float64)
    ys = np.zeros((Bb, Lx, H, P), np.float64)
    for s in range(Lx):
        for b in range(Bb):
            for hh in range(H):
                g = hh // rep
                h[b, hh] = np.exp(float(dA[b, s, hh])) * h[b, hh] + np.outer(
                    xdt[b, s, hh].astype(np.float64),
                    Bm[b, s, g].astype(np.float64))
                ys[b, s, hh] = h[b, hh] @ Cm[b, s, g].astype(np.float64)
    return ys, h


def _ssd_inputs(Lx, Bb=2, H=4, P=3, G=2, N=5, scale=0.5):
    return (RNG.normal(0, 1, (Bb, Lx, H, P)).astype(np.float32),
            -np.abs(RNG.normal(0, scale, (Bb, Lx, H))).astype(np.float32),
            RNG.normal(0, 1, (Bb, Lx, G, N)).astype(np.float32),
            RNG.normal(0, 1, (Bb, Lx, G, N)).astype(np.float32))


@pytest.mark.parametrize("Lx,chunk", [(8, 4), (12, 5), (16, 16), (7, 32)])
def test_ssd_chunked_matches_sequential_and_reference(Lx, chunk):
    xdt, dA, Bm, Cm = _ssd_inputs(Lx)
    y, state = ssm.ssd_chunked(t(xdt), t(dA), t(Bm), t(Cm), chunk)
    y_ref, state_ref = _sequential_ssd(xdt, dA, Bm, Cm)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(state.numpy(), state_ref, rtol=1e-4, atol=1e-4)
    ry, rs = ref_ssm.ssd_chunked(xdt, dA, Bm, Cm, chunk)
    np.testing.assert_allclose(np.asarray(ry), y.numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(rs), state.numpy(), **TOL)


SSM_CFG = dict(family="ssm", num_layers=1, d_model=32, num_heads=1,
               num_kv_heads=1, d_ff=0, vocab_size=64, ssm_state=8,
               ssm_expand=2, ssm_headdim=16, ssm_chunk=4, dtype="float32")


def test_ssm_decode_continues_prefill():
    from repro.models.config import ModelConfig as RefConfig

    cfg = ModelConfig(**SSM_CFG)
    pn = _init_np(ref_ssm.ssm_init, RefConfig(**SSM_CFG))
    p = {k: t(v) for k, v in pn.items()}
    Lx, Lp = 12, 8
    x = RNG.normal(0, 0.5, (B, Lx, 32)).astype(np.float32)
    full = ssm.ssm_forward(p, t(x), cfg)
    np.testing.assert_allclose(
        np.asarray(ref_ssm.ssm_forward(pn, x, RefConfig(**SSM_CFG))),
        full.numpy(), **TOL)
    _, state = ssm.ssm_forward(p, t(x[:, :Lp]), cfg, return_state=True)
    cache = transformer._ssm_prefill_cache(p, t(x[:, :Lp]), state, cfg)
    outs = []
    for s in range(Lp, Lx):
        o, cache = ssm.ssm_decode(p, t(x[:, s: s + 1]), cache, cfg)
        outs.append(o)
    np.testing.assert_allclose(full[:, Lp:].numpy(),
                               torch.cat(outs, dim=1).numpy(),
                               rtol=5e-4, atol=5e-4)


def test_ssd_initial_state_threading():
    xdt, dA, Bm, Cm = _ssd_inputs(10, Bb=1, H=2, P=4, G=1, N=6, scale=0.3)
    y_full, s_full = ssm.ssd_chunked(t(xdt), t(dA), t(Bm), t(Cm), 4)
    y1, s1 = ssm.ssd_chunked(t(xdt[:, :6]), t(dA[:, :6]), t(Bm[:, :6]),
                             t(Cm[:, :6]), 4)
    y2, s2 = ssm.ssd_chunked(t(xdt[:, 6:]), t(dA[:, 6:]), t(Bm[:, 6:]),
                             t(Cm[:, 6:]), 4, h0=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(),
                               y_full.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(s2.numpy(), s_full.numpy(), rtol=1e-4,
                               atol=1e-4)


# ============================================================ RG-LRU
GRIFFIN_CFG = dict(family="hybrid", num_layers=3, d_model=32, num_heads=2,
                   num_kv_heads=1, head_dim=16, d_ff=64, vocab_size=64,
                   lru_width=24, dtype="float32",
                   block_pattern=("rg", "rg", "attn"), window=8,
                   attention_kind="local")


@pytest.mark.parametrize("Lx", [1, 13, 40])
def test_rglru_scan_matches_sequential_and_reference(Lx):
    from repro.models import griffin as ref_griffin

    log_a = -np.abs(RNG.normal(0, 0.4, (2, Lx, 6))).astype(np.float32)
    bx = RNG.normal(0, 1, (2, Lx, 6)).astype(np.float32)
    h0 = RNG.normal(0, 1, (2, 6)).astype(np.float32)
    h = h0.astype(np.float64)
    want = np.zeros((2, Lx, 6), np.float64)
    for s in range(Lx):
        h = np.exp(log_a[:, s].astype(np.float64)) * h + bx[:, s]
        want[:, s] = h
    got = griffin.rglru_scan(t(log_a), t(bx), t(h0))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    ref = ref_griffin.rglru_scan(jnp.asarray(log_a), jnp.asarray(bx),
                                 jnp.asarray(h0))
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), **TOL)


def test_rglru_decode_continues_prefill():
    from repro.models import griffin as ref_griffin
    from repro.models.config import ModelConfig as RefConfig

    cfg = ModelConfig(**GRIFFIN_CFG)
    pn = _init_np(ref_griffin.rglru_block_init, RefConfig(**GRIFFIN_CFG))
    p = {k: t(v) for k, v in pn.items()}
    Lx, Lp = 10, 6
    x = RNG.normal(0, 0.5, (B, Lx, 32)).astype(np.float32)
    full = griffin.rglru_block_forward(p, t(x), cfg)
    _, cache = griffin.rglru_block_forward(p, t(x[:, :Lp]), cfg,
                                           return_state=True)
    outs = []
    for s in range(Lp, Lx):
        o, cache = griffin.rglru_block_decode(p, t(x[:, s: s + 1]), cache, cfg)
        outs.append(o)
    np.testing.assert_allclose(full[:, Lp:].numpy(),
                               torch.cat(outs, dim=1).numpy(),
                               rtol=5e-4, atol=5e-4)


def test_rglru_gate_bounds():
    """a_t in (0,1); sqrt(1-a^2) real."""
    cfg = ModelConfig(**GRIFFIN_CFG)
    p = griffin.rglru_block_init(Init(torch.Generator().manual_seed(1), "cpu"),
                                 cfg)
    x = t(RNG.normal(0, 2.0, (2, 5, 24)).astype(np.float32))
    log_a, bx = griffin._rglru_gates(p, x, cfg)
    a = np.exp(log_a.numpy())
    assert np.all((a > 0) & (a < 1))
    assert np.all(np.isfinite(bx.numpy()))


# ============================================================ plan
@pytest.mark.parametrize("arch", configs.ARCH_IDS)
def test_layer_plan_matches_reference(arch):
    from repro.models import transformer as ref_transformer

    ref = ref_configs.get(arch)
    assert transformer.layer_plan(configs.get(arch)) == \
        ref_transformer.layer_plan(ref)
    assert transformer.layer_plan(configs.get(arch).reduced()) == \
        ref_transformer.layer_plan(ref.reduced())
