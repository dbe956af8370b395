"""DeepSeek-V2 in the port (``models/``: MLA without a q LoRA, YaRN, the
leading dense layer, the dropless expert layer on a share of the experts
with shared experts) against the benchmark's plain reference
(``portbench/refs/deepseek_v2_ref.py``) on the CPU, at a tiny shape: 3
layers (1 dense + 2 expert), d 128, 4 heads, kv_lora 32, rope 8, nope 16,
v 16, 8 routed experts of which 4 are held, top-3, 1 shared, YaRN on.
Imports no JAX."""

import copy
import dataclasses
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.drivers import lm_serve_deepseek as drv  # noqa: E402
from portbench.refs import deepseek_v2_ref as ref  # noqa: E402
from portbench.refs.lm_ref import leaves  # noqa: E402
from repro_torch.kernels import markers  # noqa: E402
from repro_torch.models import attention, layers, moe  # noqa: E402
from repro_torch.models.transformer import layer_plan  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serving.engine import Request, ServeEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
TINY = dict(num_hidden_layers=3, hidden_size=128, num_attention_heads=4,
            num_key_value_heads=4, kv_lora_rank=32, qk_rope_head_dim=8,
            qk_nope_head_dim=16, v_head_dim=16, intermediate_size=256,
            moe_intermediate_size=64, n_routed_experts=4,
            published_n_routed_experts=8, expert_share=1,
            num_experts_per_tok=3, n_shared_experts=1, vocab_size=512,
            dtype="float32")


def hf_config(**over):
    with open(os.path.join(ROOT, "portbench", "configs",
                           "deepseek-v2-lite.json")) as f:
        c = json.load(f)
    c.update(TINY)
    c.update(over)
    return c


def setup(seed=0, **over):
    c = hf_config(**over)
    model = Model(drv.model_config(c), "cpu")
    params = ref.init_params(c, torch.Generator().manual_seed(seed), "cpu")
    return c, model, params


def tokens(n=2, length=20, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, TINY["vocab_size"], (n, length), generator=g)


def ref_logits(c, params, tok):
    r = ref.DeepSeekV2(params, c)
    with torch.no_grad():
        return r.logits(r.hidden(tok))


def test_config_holds_the_published_shape_and_the_share():
    c, model, _ = setup()
    cfg = model.cfg
    assert cfg.q_lora_rank is None and cfg.mla and cfg.moe_dropless
    assert (cfg.num_experts, cfg.router_experts, cfg.expert_offset) == (4, 8, 4)
    assert (cfg.first_k_dense, cfg.dense_d_ff, cfg.d_ff) == (1, 256, 64)
    assert layer_plan(cfg) == [("dense", [("mla", "dense_mlp")], 1),
                               ("main", [("mla", "moe")], 2)]
    # the program's params are the reference's tree, leaf for leaf
    got = {n: tuple(t.shape) for n, t in leaves(model.abstract()).items()}
    want = {n: s for n, s, _, _ in ref.leaf_specs(c)}
    assert got == want
    full = json.load(open(os.path.join(ROOT, "portbench", "configs",
                                       "deepseek-v2-lite.json")))
    assert full["published_n_routed_experts"] == 64
    assert full["n_routed_experts"] == 8 and full["num_hidden_layers"] == 27


def test_logits_equal_the_reference():
    c, model, params = setup()
    tok = tokens()
    with torch.no_grad():
        got = model.forward_logits(params, {"tokens": tok})
    torch.testing.assert_close(got, ref_logits(c, params, tok), **TOL)


def test_prefill_then_decode_equal_the_full_forward():
    """A prompt of 12, then 8 decode steps through the latent cache: each
    position's logits are the reference's full forward's."""
    c, model, params = setup()
    tok = tokens()
    want = ref_logits(c, params, tok)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tok[:, :12]}, 24)
        torch.testing.assert_close(logits, want[:, 11], **TOL)
        for i in range(12, 20):
            logits, cache = model.decode_step(
                params, tok[:, i:i + 1], torch.full((2,), i), cache)
            torch.testing.assert_close(logits, want[:, i], **TOL)


def test_engine_static_buffers_equal_the_eager_engine():
    """``ServeEngine`` over its static buffers (graphs on the card)
    serves the eager engine's tokens, its first served logits the
    reference's."""
    c, model, params = setup()
    prompts = tokens(3, 10, seed=4).numpy()
    reqs = [Request(prompt=p, max_new_tokens=6) for p in prompts]
    got = ServeEngine(model, params, 2, 16).generate(reqs)
    eager = ServeEngine(model, params, 2, 16, cuda_graph=False).generate(reqs)
    for g, e in zip(got, eager):
        np.testing.assert_array_equal(g, e)
    first = ref_logits(c, params, torch.as_tensor(prompts[:1]))[0, -1]
    assert int(got[0][0]) == int(first.argmax())


def _layer_input(c, n=24, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(1, n, c["hidden_size"], generator=g)


def test_the_shares_add_up_to_the_uncut_layer():
    """Every share's routed part (its experts' slice of the weights, its
    offset), plus the shared experts once, is the uncut reference layer
    (every expert held)."""
    c_all, _, p_all = setup(n_routed_experts=8, expert_share=0)
    f_all = p_all["main"]["b0"]["ffn"]
    x = _layer_input(c_all)
    r = ref.DeepSeekV2(p_all, c_all)
    with torch.no_grad():
        want = r._moe(x, f_all, 0)
        total = torch.zeros_like(x)
        for share in range(2):
            c = hf_config(expert_share=share)
            cfg = drv.model_config(c)
            f = {"router": f_all["router"][0]}
            for k in ("w_gate", "w_up", "w_down"):
                f[k] = f_all[k][0, share * 4:(share + 1) * 4]
            total = total + moe.dropless_forward(f, x, cfg)[0]
        s = f_all["shared"]
        total = total + layers.apply_mlp(
            {k: s[k][0] for k in s}, x, "swiglu")
    torch.testing.assert_close(total, want, **TOL)


def test_the_layer_is_dropless(monkeypatch):
    """Every token routed to one held expert (its router column far above
    the rest, on inputs all above 0): no token is dropped, each takes that
    expert's full output beside its other held experts', as the plain
    sums give them, at any chunking."""
    c, model, params = setup()
    f = copy.deepcopy({k: v[0] for k, v in params["main"]["b0"]["ffn"].items()
                       if k != "shared"})
    f["router"][:, 5] += 100.0  # expert 5: the second held of share 1
    x = _layer_input(c, n=40).abs() + 0.1
    xt = x.reshape(40, -1)
    h = torch.nn.functional.silu(xt @ f["w_gate"][1]) * (xt @ f["w_up"][1])
    w, idx = ref.DeepSeekV2(params, c).route(
        xt, {"router": f["router"][None]}, 0)
    assert bool((idx == 5).any(-1).all())
    w5 = (w * (idx == 5)).sum(-1, keepdim=True)
    held = (idx >= 4) & (idx < 8)
    cfg = dataclasses.replace(model.cfg, num_shared_experts=0)
    for chunk in (40, 7):
        monkeypatch.setattr(moe, "DISPATCH_CHUNK", chunk)
        with torch.no_grad():
            got = moe.dropless_forward(f, x, cfg)[0].reshape(40, -1)
        # expert 5's part is in every token's output
        others = torch.zeros_like(xt)
        for e in range(4):
            if e == 1:
                continue
            he = (torch.nn.functional.silu(xt @ f["w_gate"][e])
                  * (xt @ f["w_up"][e])) @ f["w_down"][e]
            we = (w * (idx == 4 + e)).sum(-1, keepdim=True)
            others = others + we * he
        torch.testing.assert_close(got, w5 * (h @ f["w_down"][1]) + others,
                                   **TOL)
    assert int(held.sum()) >= 40


def test_the_router_does_not_renormalise():
    c, model, _ = setup()
    g = torch.Generator().manual_seed(7)
    logits = torch.randn(16, 8, generator=g)
    w, idx = moe.router_weights(logits, model.cfg)
    probs = torch.softmax(logits, -1)
    torch.testing.assert_close(w, torch.gather(probs, -1, idx))
    assert bool((w.sum(-1) < 1.0 - 1e-3).all())
    assert idx.shape == (16, 3)


def test_yarn_frequencies_and_scale_follow_the_closed_form():
    """``layers.yarn_inv_freq`` and ``attention.mla_scale`` against the
    formula written out here (numpy, float64), and the reference's."""
    c, model, _ = setup(qk_rope_head_dim=64)
    cfg = model.cfg
    y = c["rope_scaling"]
    dim, base, factor = 64, 10000.0, 40.0

    def turns_dim(turns):
        return dim * math.log(4096 / (turns * 2 * math.pi)) / (2 * math.log(base))

    low = max(math.floor(turns_dim(32)), 0)
    high = min(math.ceil(turns_dim(1)), dim - 1)
    assert (low, high) == (10, 23)
    i = np.arange(dim // 2)
    theta = base ** (-2.0 * i / dim)
    ramp = np.clip((i - low) / (high - low), 0, 1)
    want = theta / factor * ramp + theta * (1 - ramp)
    got = layers.yarn_inv_freq(dim, base, factor, 4096, 32.0, 1.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(ref.yarn_inv_freq(c, "cpu").numpy(), want,
                               rtol=1e-6)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert y["mscale_all_dim"] == 0.707
    scale = (16 + 64) ** -0.5 * m * m
    assert attention.mla_scale(cfg) == pytest.approx(scale, rel=1e-12)
    assert ref.softmax_scale(c) == pytest.approx(scale, rel=1e-12)


def test_markers_bracket_each_moe_layer_and_mla_core(monkeypatch):
    """One decode step: an MLA pair per layer and a MoE pair per expert
    layer, in layer order (recorded where the card would launch them)."""
    c, model, params = setup()
    tok = tokens(2, 6)
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": tok}, 8)
        seen = []
        monkeypatch.setattr(markers, "mark",
                            lambda phase, device: seen.append(phase))
        model.decode_step(params, tok[:, :1], torch.full((2,), 6), cache)
    mla = ["mla_begin", "mla_end"]
    assert seen == mla + (mla + ["moe_begin", "moe_end"]) * 2


def test_the_load_counter_counts_the_routed_pairs():
    """The device counter's increments, published through ``obs.metrics``,
    are the pairs each held expert took, prefill and decode alike."""
    c, model, params = setup()
    tok = tokens(2, 10)
    moe.publish_expert_load(MetricsRegistry(), "cpu")
    with torch.no_grad():
        model.forward_logits(params, {"tokens": tok})
    reg = MetricsRegistry()
    got = moe.publish_expert_load(reg, "cpu")
    r = ref.DeepSeekV2(params, c)
    want = [0] * 4
    with torch.no_grad():
        x = params["embed"]["table"][tok]
        pos = torch.arange(10)
        r._inv = ref.yarn_inv_freq(c, "cpu")
        x = r._layer(x, "dense", 0, pos)
        for layer in range(2):
            b = params["main"]["b0"]
            h = ref._rms(x + r._attention(ref._rms(
                x, b["norm1"]["scale"][layer], c["rms_norm_eps"]),
                b["mixer"], layer, pos), b["norm2"]["scale"][layer],
                c["rms_norm_eps"])
            _, idx = r.route(h.reshape(20, -1), b["ffn"], layer)
            for e in range(4):
                want[e] += int((idx == 4 + e).sum())
            x = r._layer(x, "main", layer, pos)
    assert got == want and sum(got) > 0
    assert [reg.counter(f"moe.routed_pairs.e{i}").value
            for i in range(4)] == want
