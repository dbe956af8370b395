"""The absorbed-MLA decode kernel (``kernels/mla_decode``,
``csrc/mla_decode.cu``) against its plain version ``_mla_latent`` on the
card, in bfloat16; its graphed replay, its counters, and a DeepSeek-V2
decode step through it, eager and captured.  Imports neither JAX nor the
reference:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_mla_decode_cuda.py

Without a CUDA device every test here skips.

Tolerance: the kernel rounds where ``_mla_latent`` rounds (the scores'
float32 latent and rope dot products, added, times the scale; the float32
softmax; the weights to bfloat16 once normalised; the float32 context
rounded once to bfloat16); only the order of its float32 sums differs
from the library products' (tensor-core sums in the kernel).  A
different order moves a score or the softmax's sum by a few float32
ulps, which flips a weight's bfloat16 rounding only where it lay within
that of a midpoint, and moves the float32 context before its one
rounding.  So most outputs are equal or one bfloat16 ulp apart (at least
99 % within 1 ulp of their magnitude), and the worst is bounded by one
ulp plus the flipped weights' share, at most 2^-7 of every weight, of
``sum_j w_j |c_kv_j|``, the output's magnitude before cancellation."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import mla_decode as mk
from repro_torch.models import attention
from repro_torch.models.config import DeepSeekV2Config

# the DeepSeek serving cell's decode: 128 rows, a cache of 1,536, 16 heads
CELL = dict(B=128, S=1536, H=16)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the MLA decode kernel runs only "
                    "on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, B, S, H, pos, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    shapes = ((B, 1, H, 512), (B, 1, H, 64), (B, S, 512), (B, S, 64))
    q, q_rope, c_kv, k_rope = (
        torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
        for s in shapes)
    pos = torch.as_tensor(pos, dtype=torch.long, device=dev)
    return q, q_rope, c_kv, k_rope, pos


def _kv_pos(pos, S):
    j = torch.arange(S, device=pos.device)[None, :]
    return torch.where(j <= pos[:, None], j, -1)


def _plain(q, q_rope, c_kv, k_rope, pos, scale):
    """``_mla_latent`` as ``mla_decode`` calls it on the full cache."""
    return attention._mla_latent(q, q_rope, c_kv, k_rope, pos[:, None],
                                 _kv_pos(pos, c_kv.shape[1]), scale)


def _magnitude(q, q_rope, c_kv, k_rope, pos, scale):
    """``sum_j w_j |c_kv_j|`` with the plain version's weights."""
    s = torch.einsum("blhr,bsr->bhls", q.float(), c_kv.float())
    s = s + torch.einsum("blhd,bsd->bhls", q_rope.float(), k_rope.float())
    mask = attention._mask(pos[:, None], _kv_pos(pos, c_kv.shape[1]),
                           None)[:, None]
    s = torch.where(mask, s * scale, attention.NEG_INF)
    w = torch.softmax(s, dim=-1).to(torch.bfloat16).float()
    return torch.einsum("bhls,bsr->blhr", w, c_kv.float().abs())


def _bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significant bits), for normal values."""
    a = x.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _check_close(got, want, args, scale):
    """The module's tolerance; returns (share within 1 ulp, worst error
    over its bound)."""
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    ulp = _bf16_ulp(want)
    within = float((err <= ulp).float().mean())
    bound = ulp + 2.0 ** -7 * _magnitude(*args, scale)
    worst = float((err / bound).max())
    assert torch.isfinite(got.float()).all()
    assert within >= 0.99, within
    assert worst <= 1.0, worst
    return within, worst


def _cell_pos(case):
    B, S = CELL["B"], CELL["S"]
    if case == "mixed":
        rng = np.random.default_rng(7)
        # the cell's rows run from 1,024 to 1,535; here also the edges of
        # a CTA's part (192 rows) and of a copy group (64), the cache's
        # end, past it, and a row with no valid position
        fixed = [0, 1, 63, 64, 191, 192, 1023, 1024, S - 2, S - 1, S,
                 S + 300, -1]
        return fixed + list(rng.integers(1024, S, B - len(fixed)))
    return [int(case)] * B


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["0", "1023", "1535", "-1", "mixed"])
def test_kernel_matches_the_plain_version_at_the_cell_shape(cuda_device,
                                                             case):
    args = _inputs(cuda_device, **CELL, pos=_cell_pos(case))
    scale = 0.0722  # DeepSeek-V2-Lite's: 192 ** -0.5 times YaRN's mscale^2
    got = mk.mla_decode(*args, scale)
    _check_close(got, _plain(*args, scale), args, scale)
    if case == "0":
        # one valid row: its weight is exactly 1, so ctx is that c_kv row
        c_kv = args[2]
        assert torch.equal(got[:, 0], c_kv[:, 0, None].expand_as(got[:, 0]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    dict(B=3, S=1536, H=32),  # two head groups a row
    dict(B=5, S=700, H=16),  # 128 rows a CTA, the last part short
    dict(B=4, S=64, H=16),  # one group, most CTAs without a row
    dict(B=2, S=1, H=16),  # one cache row
], ids=["h32", "s700", "s64", "s1"])
def test_kernel_matches_the_plain_version_at_other_shapes(cuda_device, shape):
    B, S = shape["B"], shape["S"]
    pos = [min(S // 3 + 17 * i, S - 1) for i in range(B - 1)] + [S - 1]
    args = _inputs(cuda_device, **shape, pos=pos, seed=1)
    got = mk.mla_decode(*args, 0.1)
    _check_close(got, _plain(*args, 0.1), args, 0.1)


@pytest.mark.cuda
def test_graphed_replay_equals_eager_and_runs_repeat(cuda_device):
    args = _inputs(cuda_device, **CELL, pos=_cell_pos("mixed"))
    q, q_rope, c_kv, k_rope, pos = args
    fn = mk.mla_decode
    before = (fn.launches, fn.captured)
    eager = fn(*args, 0.0722)
    again = fn(*args, 0.0722)
    assert torch.equal(eager, again)  # deterministic: bit for bit
    assert (fn.launches, fn.captured) == (before[0] + 2, before[1])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = fn(*args, 0.0722)
    assert (fn.launches, fn.captured) == (before[0] + 2, before[1] + 1)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static, eager)
    # the replay reads pos on the device: move every row one step on
    pos.add_(1)
    graph.replay()
    moved = fn(*args, 0.0722)
    torch.cuda.synchronize()
    assert torch.equal(static, moved)
    assert fn.captured == before[1] + 1  # a replay launches, not captures


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    q, q_rope, c_kv, k_rope, pos = _inputs(cuda_device, B=2, S=64, H=16,
                                           pos=[3, 5])
    with pytest.raises(ValueError, match="contiguous"):
        mk.mla_decode(q, q_rope, c_kv[:, ::2], k_rope[:, ::2], pos, 0.1)
    with pytest.raises(TypeError, match="bfloat16"):
        mk.mla_decode(q.float(), q_rope, c_kv, k_rope, pos, 0.1)
    with pytest.raises(ValueError, match="does not take"):
        mk.mla_decode(q[:, :, :8], q_rope[:, :, :8], c_kv, k_rope, pos, 0.1)
    long = _inputs(cuda_device, B=2, S=mk.ROWS_MAX + 1, H=16, pos=[3, 5])
    with pytest.raises(ValueError, match="rows a cluster holds"):
        mk.mla_decode(*long, 0.1)


# DeepSeek-V2-Lite's 27 layers and latent widths (16 heads, rank 512, rope
# 64, nope 128, v 128), narrow elsewhere, in bfloat16
DSV2 = DeepSeekV2Config(
    name="deepseek-v2-mla", family="moe", num_layers=27, d_model=256,
    num_heads=16, num_kv_heads=16, head_dim=192, d_ff=64, vocab_size=512,
    norm_kind="rmsnorm", norm_eps=1e-6, mla=True, q_lora_rank=None,
    kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
    v_head_dim=128, num_experts=4, num_experts_per_tok=2,
    router_softmax_order="softmax_then_topk_raw", router_experts=8,
    expert_offset=0, num_shared_experts=1, first_k_dense=1, dense_d_ff=256,
    yarn_factor=40.0, yarn_mscale=0.707, yarn_mscale_all_dim=0.707,
    dtype="bfloat16")


@pytest.mark.cuda
def test_a_deepseek_decode_step_captured_equals_the_eager_step(cuda_device):
    """One decode step of every layer through the kernel, eager and then
    captured in a CUDA graph and replayed on the same cache: bit for bit
    the same logits; the capture records one launch a layer, and nothing
    falls back."""
    from repro_torch.models.model import Model

    model = Model(DSV2)
    params = model.init(0, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    B, P = 4, 40
    toks = torch.randint(0, DSV2.vocab_size, (B, P), generator=gen,
                         device=cuda_device)
    fn = mk.mla_decode
    fn.launches = fn.captured = fn.fallbacks = 0
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": toks}, 96)
        pos = torch.tensor([P, P - 7, P + 3, P - 20], device=cuda_device)
        tok = toks[:, -1:]
        eager, _ = model.decode_step(params, tok, pos, cache)
        assert (fn.launches, fn.captured) == (DSV2.num_layers, 0)
        # the step rewrites the cache rows at pos with the same values, so
        # a replay on the same cache computes the same step
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static, _ = model.decode_step(params, tok, pos, cache)
        assert fn.captured == DSV2.num_layers
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(static, eager)
    assert fn.fallbacks == 0


@pytest.mark.cuda
def test_the_serving_engine_decodes_through_the_kernel(cuda_device):
    """The graphed ``ServeEngine`` on the 27-layer model: the decode
    capture records 27 launches, the signature's first, eager call
    launches 27, none falls back, and the greedy tokens equal the eager
    engine's."""
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Request, ServeEngine

    model = Model(DSV2)
    params = model.init(0, cuda_device)
    rng = np.random.default_rng(3)
    reqs = [Request(prompt=rng.integers(0, DSV2.vocab_size, 24)
                    .astype(np.int32), max_new_tokens=8) for _ in range(4)]
    fn = mk.mla_decode
    fn.launches = fn.captured = fn.fallbacks = 0
    eng = ServeEngine(model, params, batch_size=4, cache_len=48)
    outs = eng.generate(reqs)
    assert eng._decode._cache_size() == 1
    assert fn.captured == DSV2.num_layers
    assert fn.launches == DSV2.num_layers
    assert fn.fallbacks == 0
    eager = ServeEngine(model, params, batch_size=4, cache_len=48,
                        cuda_graph=False).generate(reqs)
    assert all(np.array_equal(a, b) for a, b in zip(outs, eager))
    assert fn.fallbacks == 0


@pytest.mark.cuda
def test_minicpm3_latent_shape_on_the_card_falls_back(cuda_device):
    """MiniCPM3's 40 heads of rank 256 are not the kernel's: each decode
    layer runs ``_mla_latent`` and counts a fallback."""
    from repro_torch import configs
    from repro_torch.models.model import Model

    base = configs.get("minicpm3-4b")
    cfg = dataclasses.replace(base.reduced(), num_heads=base.num_heads,
                              num_kv_heads=base.num_kv_heads,
                              kv_lora_rank=base.kv_lora_rank,
                              qk_rope_head_dim=base.qk_rope_head_dim,
                              dtype="bfloat16")
    model = Model(cfg)
    params = model.init(0, cuda_device)
    fn = mk.mla_decode
    fn.launches = fn.captured = fn.fallbacks = 0
    toks = torch.zeros((2, 8), dtype=torch.long, device=cuda_device)
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": toks}, 16)
        pos = torch.full((2,), 8, dtype=torch.long, device=cuda_device)
        model.decode_step(params, toks[:, :1], pos, cache)
    assert (fn.launches, fn.fallbacks) == (0, cfg.num_layers)
