"""Routing of the LM decode step's attention, on the CPU: where
``attention.gqa_decode`` runs the hand-written kernel
(``kernels/decode_attention``) and where it keeps ``attend_full``.

The kernel runs only on the card.  Here ``decode_attention._on_card`` is
made to answer for CUDA tensors, and the launch is replaced by a stand-in
that runs ``attend_full`` on the arguments the routing passes, so the
decode step's logits must equal the plain path's bit for bit wherever the
kernel is taken; where it is not, the stand-in must never run, nothing
may load a built library, and ``fallbacks`` counts each call.  Imports no
JAX."""

import dataclasses

import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as da
from repro_torch.models import attention
from repro_torch.models.model import Model

# stablelm reduced, at a head dim and precision the kernel takes
BASE = dataclasses.replace(configs.get("stablelm-1.6b").reduced(),
                           head_dim=64, dtype="bfloat16")
B, PROMPT, STEPS, CACHE = 2, 5, 3, 16


@pytest.fixture
def counters():
    fn = da.decode_attention
    saved = (fn.launches, fn.captured, fn.fallbacks)
    fn.launches = fn.captured = fn.fallbacks = 0
    yield fn
    fn.launches, fn.captured, fn.fallbacks = saved


@pytest.fixture
def no_library(monkeypatch):
    def refuse(name):
        raise AssertionError(f"the built library {name!r} was loaded")

    monkeypatch.setattr(_build, "load", refuse)


def _stand_in(calls):
    """A launch that runs ``attend_full`` on what the wrapper passed: the
    same inputs and rows ``j <= pos[b]`` valid."""

    def launch(q, k, v, pos, scale):
        calls.append((tuple(q.shape), tuple(k.shape), scale))
        j = torch.arange(k.shape[1])[None, :]
        kv_pos = torch.where(j <= pos[:, None], j, -1)
        return attention.attend_full(q, k, v, pos[:, None], kv_pos,
                                     window=None, scale=scale)

    return launch


def _decode_logits(cfg):
    """Logits of a prefill and ``STEPS`` greedy decode steps on the CPU."""
    model = Model(cfg)
    params = model.init(0, "cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks}, CACHE)
        out = [logits]
        pos = torch.full((B,), PROMPT, dtype=torch.long)
        for s in range(STEPS):
            tok = logits.argmax(-1)[:, None]
            logits, cache = model.decode_step(params, tok, pos + s, cache)
            out.append(logits)
    return torch.stack(out)


@pytest.mark.parametrize("D,H,Kv", [(64, 4, 4), (64, 4, 2), (96, 4, 4),
                                    (128, 4, 1)],
                         ids=["d64-g1", "d64-g2", "d96-g1", "d128-g4"])
def test_full_bf16_cache_on_the_card_takes_the_kernel(monkeypatch, counters,
                                                       no_library, D, H, Kv):
    cfg = dataclasses.replace(BASE, head_dim=D, num_heads=H, num_kv_heads=Kv)
    want = _decode_logits(cfg)
    calls = []
    monkeypatch.setattr(da, "_on_card", lambda t: True)
    monkeypatch.setattr(da, "_launch", _stand_in(calls))
    got = _decode_logits(cfg)
    assert torch.equal(got, want)
    # one call a layer and decode step, at the model's shapes and scale
    assert len(calls) == cfg.num_layers * STEPS
    assert set(calls) == {((B, 1, Kv, H // Kv, D), (B, CACHE, Kv, D),
                           D ** -0.5)}
    assert counters.launches == len(calls)
    assert counters.fallbacks == counters.captured == 0


FALLBACKS = {
    "ring": dict(attention_kind="swa", window=8),
    "kv_cache_quant": dict(kv_cache_quant=True),
    "softcap": dict(attn_logit_softcap=30.0),
    "head_dim_256": dict(head_dim=256),
    "float32": dict(dtype="float32"),
    "nine_groups": dict(num_heads=9, num_kv_heads=1),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_other_decode_calls_on_the_card_keep_attend_full(monkeypatch, counters,
                                                         no_library, case):
    cfg = dataclasses.replace(BASE, **FALLBACKS[case])
    want = _decode_logits(cfg)
    assert counters.fallbacks == 0  # off the card nothing is counted
    calls = []
    monkeypatch.setattr(da, "_on_card", lambda t: True)
    monkeypatch.setattr(da, "_launch", _stand_in(calls))
    got = _decode_logits(cfg)
    assert torch.equal(got, want)
    assert calls == []
    assert counters.fallbacks == cfg.num_layers * STEPS
    assert counters.launches == counters.captured == 0


def test_cpu_tensors_keep_attend_full(monkeypatch, counters, no_library):
    calls = []
    monkeypatch.setattr(da, "_launch", _stand_in(calls))
    _decode_logits(BASE)
    assert calls == []
    assert counters.fallbacks == counters.launches == 0


def _qkv(Lq=1, D=64, G=1, S=32, dtype=torch.bfloat16, device="cpu"):
    q = torch.zeros((2, Lq, 4, G, D), dtype=dtype, device=device)
    k = torch.zeros((2, S, 4, D), dtype=dtype, device=device)
    return q, k, k.clone()


PLAIN = dict(ring=False, quantized=False, softcap=None)


@pytest.mark.parametrize("case,qkv,kw,taken", [
    ("plain", {}, {}, True),
    ("lq2", dict(Lq=2), {}, False),
    ("d256", dict(D=256), {}, False),
    ("d32", dict(D=32), {}, False),
    ("g8", dict(G=8), {}, True),
    ("g9", dict(G=9), {}, False),
    ("float16", dict(dtype=torch.float16), {}, False),
    ("scores_fill_smem", dict(G=2, S=da.SCORES_MAX // 2), {}, True),
    ("scores_past_smem", dict(G=2, S=da.SCORES_MAX // 2 + 1), {}, False),
    ("ring", {}, dict(ring=True), False),
    ("quantized", {}, dict(quantized=True), False),
    ("softcap", {}, dict(softcap=50.0), False),
], ids=lambda x: x if isinstance(x, str) else "")
def test_takes(case, qkv, kw, taken):
    q, k, v = _qkv(device="meta", **qkv)
    assert da.takes(q, k, v, **{**PLAIN, **kw}) is taken


def test_dtensor_cache_keeps_attend_full(monkeypatch, counters):
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch import dryrun

    q, k, v = _qkv(device="meta")
    assert da.takes(q, k, v, **PLAIN)
    monkeypatch.setattr(da, "_on_card", lambda t: True)
    with dryrun.plan_group(make_production_mesh(shape=(2,), axes=("data",))
                           ) as (dm, _):
        dq, dk, dv = (DTensor.from_local(t, dm, [Replicate()], run_check=False)
                      for t in (q, k, v))
        assert not da.takes(dq, dk, dv, **PLAIN)
        assert not da.takes(q, dk, dv, **PLAIN)
        assert not da.routes(q, dk, dv, **PLAIN)
    assert counters.fallbacks == 1


def test_plan_and_bytes_bound():
    p = da.plan(32, 1280, 32, 1, 64)
    assert p.grid == (32, 32) and p.ctas == 1024 and p.threads == da.THREADS
    assert p.smem == (1280 + da.WARPS * 64) * 4
    # the cell's decode: ~1,152 valid rows of K and V a (b, head)
    assert da.bytes_bound([1151] * 32, 1280, 32, 64) == 2 * 1152 * 32 * 32 * 128
    assert da.bytes_bound([-1, 5000], 1280, 1, 64) == 2 * 2 * 1280 * 128
    for bad in (dict(D=256), dict(G=9), dict(S=da.SCORES_MAX + 1)):
        args = dict(B=2, S=64, Kv=4, G=1, D=64, **{})
        args.update(bad)
        with pytest.raises(ValueError):
            da.plan(**args)


def test_wrapper_refuses_the_cpu_and_what_the_kernel_lacks(no_library):
    q, k, v = _qkv()
    pos = torch.zeros(2, dtype=torch.long)
    with pytest.raises(ValueError, match="card only"):
        da.decode_attention(q, k, v, pos, 0.125)
    # within the routes, the shape checks raise before any launch
    with pytest.raises(ValueError, match="pos must be"):
        da._check(q, k, v, pos[:1])
    with pytest.raises(TypeError, match="bfloat16"):
        da._check(q.float(), k, v, pos)
    with pytest.raises(ValueError, match="contiguous"):
        da._check(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, pos)
