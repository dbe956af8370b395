"""Routing of MLA's absorbed decode step, on the CPU: where
``attention.mla_decode`` runs the hand-written kernel
(``kernels/mla_decode``) and where it keeps ``_mla_latent``.

The kernel runs only on the card.  Here ``mla_decode._on_card`` is made
to answer for CUDA tensors, and the launch is replaced by a stand-in that
runs ``_mla_latent`` on the arguments the routing passes, so the decode
step's logits must equal the plain path's bit for bit wherever the kernel
is taken; where it is not, the stand-in must never run, nothing may load
a built library, and ``fallbacks`` counts each call.  On CPU tensors the
decode step's output and cache equal those of the absorbed form as it was
written before the kernel, bit for bit.  Imports no JAX."""

import dataclasses

import pytest
import torch
from torch.utils._pytree import tree_leaves

from repro_torch import configs
from repro_torch.kernels import _build
from repro_torch.kernels import mla_decode as mk
from repro_torch.models import attention
from repro_torch.models.config import DeepSeekV2Config
from repro_torch.models.model import Model

# DeepSeek-V2-Lite's latent widths (16 heads, rank 512, rope 64) in a
# narrow three-layer model, in the precision the kernel takes
DSV2 = DeepSeekV2Config(
    name="deepseek-v2-mla", family="moe", num_layers=3, d_model=64,
    num_heads=16, num_kv_heads=16, head_dim=96, d_ff=32, vocab_size=256,
    norm_kind="rmsnorm", norm_eps=1e-6, mla=True, q_lora_rank=None,
    kv_lora_rank=512, qk_nope_head_dim=32, qk_rope_head_dim=64,
    v_head_dim=16, num_experts=2, num_experts_per_tok=2,
    router_softmax_order="softmax_then_topk_raw", router_experts=4,
    expert_offset=0, num_shared_experts=1, first_k_dense=1, dense_d_ff=64,
    yarn_factor=40.0, yarn_mscale=0.707, yarn_mscale_all_dim=0.707,
    dtype="bfloat16")
B, PROMPT, STEPS, CACHE = 2, 5, 3, 12


@pytest.fixture
def counters():
    fn = mk.mla_decode
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
    """A launch that runs ``_mla_latent`` on what the wrapper passed: the
    same inputs and rows ``j <= pos[b]`` valid."""

    def launch(q, q_rope, c_kv, k_rope, pos, scale):
        calls.append((tuple(q.shape), tuple(c_kv.shape), scale))
        j = torch.arange(c_kv.shape[1])[None, :]
        kv_pos = torch.where(j <= pos[:, None], j, -1)
        return attention._mla_latent(q, q_rope, c_kv, k_rope, pos[:, None],
                                     kv_pos, scale)

    return launch


def _decode(cfg, cache_len=CACHE):
    """Logits of a prefill and ``STEPS`` greedy decode steps on the CPU,
    and the last cache."""
    model = Model(cfg)
    params = model.init(0, "cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen)
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": toks}, cache_len)
        out = [logits]
        pos = torch.full((B,), PROMPT, dtype=torch.long)
        for s in range(STEPS):
            tok = logits.argmax(-1)[:, None]
            logits, cache = model.decode_step(params, tok, pos + s, cache)
            out.append(logits)
    return torch.stack(out), cache


def test_deepseek_latent_widths_on_the_card_take_the_kernel(
        monkeypatch, counters, no_library):
    want, _ = _decode(DSV2)
    calls = []
    monkeypatch.setattr(mk, "_on_card", lambda t: True)
    monkeypatch.setattr(mk, "_launch", _stand_in(calls))
    got, _ = _decode(DSV2)
    assert torch.equal(got, want)
    # one call a layer (every block is MLA) and decode step, at the
    # model's shapes and scale
    assert len(calls) == DSV2.num_layers * STEPS
    assert set(calls) == {((B, 1, 16, 512), (B, CACHE, 512),
                           attention.mla_scale(DSV2))}
    assert counters.launches == len(calls)
    assert counters.fallbacks == counters.captured == 0


MINICPM3 = configs.get("minicpm3-4b")
FALLBACKS = {
    # MiniCPM3-4B's latent shape: 40 heads, rank 256, rope 32
    "minicpm3": MINICPM3.reduced(
        num_heads=MINICPM3.num_heads, num_kv_heads=MINICPM3.num_kv_heads,
        kv_lora_rank=MINICPM3.kv_lora_rank,
        qk_rope_head_dim=MINICPM3.qk_rope_head_dim, dtype="bfloat16"),
    "float32": dataclasses.replace(DSV2, dtype="float32"),
    "heads_24": dataclasses.replace(DSV2, num_heads=24, num_kv_heads=24),
    "rank_256": dataclasses.replace(DSV2, kv_lora_rank=256),
    "rope_32": dataclasses.replace(DSV2, qk_rope_head_dim=32),
}


@pytest.mark.parametrize("case", sorted(FALLBACKS))
def test_other_decode_calls_on_the_card_keep_the_plain_version(
        monkeypatch, counters, no_library, case):
    cfg = FALLBACKS[case]
    want, _ = _decode(cfg)
    assert counters.fallbacks == 0  # off the card nothing is counted
    calls = []
    monkeypatch.setattr(mk, "_on_card", lambda t: True)
    monkeypatch.setattr(mk, "_launch", _stand_in(calls))
    got, _ = _decode(cfg)
    assert torch.equal(got, want)
    assert calls == []
    assert counters.fallbacks == cfg.num_layers * STEPS
    assert counters.launches == counters.captured == 0


def test_a_cache_past_a_clusters_rows_keeps_the_plain_version(
        monkeypatch, counters, no_library):
    calls = []
    monkeypatch.setattr(mk, "_on_card", lambda t: True)
    monkeypatch.setattr(mk, "_launch", _stand_in(calls))
    _decode(DSV2, cache_len=mk.ROWS_MAX + 1)
    assert calls == []
    assert counters.fallbacks == DSV2.num_layers * STEPS


def _absorbed_before(q_nope, q_rope, c_kv, k_rope, kv_b_k, kv_b_v, q_pos,
                     kv_pos, scale, pos=None):
    """The absorbed form as it was written before the kernel."""
    assert pos is None
    q_eff = torch.einsum("blhd,rhd->blhr", q_nope, kv_b_k.to(q_nope.dtype))
    s = torch.einsum("blhr,bsr->bhls", q_eff.float(), c_kv.float())
    s = s + torch.einsum("blhd,bsd->bhls", q_rope.float(), k_rope.float())
    s = s * scale
    mask = attention._mask(q_pos, kv_pos, None)[:, None]
    s = torch.where(mask, s, attention.NEG_INF)
    w = torch.softmax(s, dim=-1).to(c_kv.dtype)
    ctx = torch.einsum("bhls,bsr->blhr", w, c_kv)
    return torch.einsum("blhr,rhd->blhd", ctx, kv_b_v.to(ctx.dtype))


@pytest.mark.parametrize("cfg", [DSV2, FALLBACKS["minicpm3"]],
                         ids=["deepseek", "minicpm3"])
def test_cpu_tensors_keep_the_plain_path_unchanged(monkeypatch, counters,
                                                   no_library, cfg):
    calls = []
    monkeypatch.setattr(mk, "_launch", _stand_in(calls))
    got, got_cache = _decode(cfg)
    assert calls == []
    assert counters.fallbacks == counters.launches == 0
    monkeypatch.setattr(attention, "_mla_absorbed", _absorbed_before)
    want, want_cache = _decode(cfg)
    assert torch.equal(got, want)
    got_leaves, want_leaves = (tree_leaves(c) for c in (got_cache, want_cache))
    assert len(got_leaves) == len(want_leaves) > 0
    assert all(torch.equal(a, b) for a, b in zip(got_leaves, want_leaves))


def _qkv(Lq=1, H=16, r=512, dr=64, S=32, dtype=torch.bfloat16,
         device="meta", B=2):
    q = torch.zeros((B, Lq, H, 32), dtype=dtype, device=device)
    q_rope = torch.zeros((B, Lq, H, dr), dtype=dtype, device=device)
    c_kv = torch.zeros((B, S, r), dtype=dtype, device=device)
    k_rope = torch.zeros((B, S, dr), dtype=dtype, device=device)
    return q, q_rope, c_kv, k_rope


@pytest.mark.parametrize("case,kw,taken", [
    ("deepseek", {}, True),
    ("heads_32", dict(H=32), True),
    ("heads_128", dict(H=128), True),
    ("heads_8", dict(H=8), False),
    ("heads_40", dict(H=40), False),
    ("minicpm3", dict(H=40, r=256, dr=32), False),
    ("rank_256", dict(r=256), False),
    ("rope_32", dict(dr=32), False),
    ("lq2", dict(Lq=2), False),
    ("float32", dict(dtype=torch.float32), False),
    ("float16", dict(dtype=torch.float16), False),
    ("cache_1536", dict(S=mk.ROWS_MAX), True),
    ("cache_1537", dict(S=mk.ROWS_MAX + 1), False),
    ("cache_1", dict(S=1), True),
], ids=lambda x: x if isinstance(x, str) else "")
def test_takes(case, kw, taken):
    assert mk.takes(*_qkv(**kw)) is taken


def test_takes_needs_every_tensor_in_bfloat16():
    for i in range(4):
        ts = list(_qkv())
        ts[i] = ts[i].float()
        assert not mk.takes(*ts)


def test_routes_counts_card_calls_alone(monkeypatch, counters):
    ts = _qkv(H=40, r=256, dr=32)
    assert not mk.routes(*ts)  # meta tensors are not the card's
    assert counters.fallbacks == 0
    monkeypatch.setattr(mk, "_on_card", lambda t: True)
    assert not mk.routes(*ts)
    assert mk.routes(*_qkv())
    assert counters.fallbacks == 1


def test_dtensor_cache_keeps_the_plain_version(monkeypatch, counters):
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_production_mesh

    ts = _qkv()
    assert mk.takes(*ts)
    monkeypatch.setattr(mk, "_on_card", lambda t: True)
    with dryrun.plan_group(make_production_mesh(shape=(2,), axes=("data",))
                           ) as (dm, _):
        dts = [DTensor.from_local(t, dm, [Replicate()], run_check=False)
               for t in ts]
        assert not mk.takes(*dts)
        for i in range(4):  # any one of them a DTensor
            mixed = list(ts)
            mixed[i] = dts[i]
            assert not mk.takes(*mixed)
        assert not mk.routes(ts[0], *dts[1:])
    assert counters.fallbacks == 1


def test_plan():
    # the DeepSeek serving cell: 8 CTAs of 192 rows a (row, 16 heads)
    p = mk.plan(128, 1536, 16)
    assert p.grid == (8, 1, 128) and p.ctas == 1024
    assert (p.threads, p.cluster, p.rows) == (256, 8, 192)
    # the c_kv rows, then over the dead k_rope rows the weights, the row's
    # max and sum, and 7 peers' partials of 16 x 64 float32; 3 barriers
    assert p.smem == 192 * 1024 + 192 * 32 + 128 + 7 * 4096 + 24 == 231_576
    # the weights' place holds at least the CTA's own partial
    assert mk.smem(64) == 64 * 1024 + 4096 + 128 + 7 * 4096 + 24
    assert p.smem <= 232_448 and mk.smem(192) >= 192 * (512 + 64) * 2
    # S / 8 rows rounded up to whole groups of 64
    for S, rows in ((1, 64), (512, 64), (513, 128), (1024, 128),
                    (1025, 192), (1280, 192)):
        assert mk.plan(4, S, 32).rows == rows, S
        assert mk.plan(4, S, 32).rows * mk.CLUSTER >= S
    assert mk.plan(3, 64, 128).grid == (8, 8, 3)
    for bad in (dict(S=1537), dict(S=0), dict(H=40), dict(H=8),
                dict(rank=256), dict(rope=32), dict(B=65_536)):
        args = dict(B=2, S=64, H=16)
        args.update(bad)
        with pytest.raises(ValueError):
            mk.plan(**args)


def test_bytes_bounds():
    # the cell's decode: 128 rows from position 1,024 to 1,535, on
    # average ~1,280 valid rows a row: 189 MB a launch read once
    pos = [1023 + i for i in range(128)]
    rows = sum(p + 1 for p in pos)
    assert mk.valid_rows(pos, 1536) == rows
    assert mk.bytes_bound(pos, 1536) == rows * 1152
    assert mk.bytes_two_reads(pos, 1536) == rows * (1152 + 1024)
    assert 188e6 < mk.bytes_bound([1279] * 128, 1536) < 189e6
    # a row past the cache reads all S rows; a row with no valid position
    # weighs all S rows alike, so reads them all too
    assert mk.valid_rows([-1, 5000, 0], 1536) == 1536 + 1536 + 1
    assert mk.bytes_bound([-1], 64) == 64 * 1152


def test_wrapper_refuses_the_cpu_and_what_the_kernel_lacks(no_library):
    q, q_rope, c_kv, k_rope = _qkv(device="cpu")
    q = torch.zeros((2, 1, 16, 512), dtype=torch.bfloat16)
    pos = torch.zeros(2, dtype=torch.long)
    with pytest.raises(ValueError, match="card only"):
        mk.mla_decode(q, q_rope, c_kv, k_rope, pos, 0.1)
    # within the routes, the checks raise before any launch
    mk._check(q, q_rope, c_kv, k_rope, pos)
    with pytest.raises(ValueError, match="pos must be"):
        mk._check(q, q_rope, c_kv, k_rope, pos[:1])
    with pytest.raises(TypeError, match="int64"):
        mk._check(q, q_rope, c_kv, k_rope, pos.int())
    with pytest.raises(TypeError, match="bfloat16"):
        mk._check(q, q_rope, c_kv.float(), k_rope, pos)
    with pytest.raises(ValueError, match="c_kv must be"):
        mk._check(q, q_rope, c_kv[..., :256], k_rope, pos)
    with pytest.raises(ValueError, match="k_rope must be"):
        mk._check(q, q_rope, c_kv, k_rope[:, :5], pos)
    with pytest.raises(ValueError, match="contiguous"):
        mk._check(q, q_rope, c_kv.transpose(0, 1).contiguous()
                  .transpose(0, 1), k_rope, pos)
