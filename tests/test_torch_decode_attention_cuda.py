"""The decode-attention kernel (``kernels/decode_attention``,
``csrc/decode_attention.cu``) against ``attend_full`` on the card, in
bfloat16; its graphed replay, its counters, and the serving engine's
decode through it.  Imports neither JAX nor the reference:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_decode_attention_cuda.py

Without a CUDA device every test here skips.

Tolerance: the kernel rounds where ``attend_full`` rounds (the scores'
float32 dot products times the scale, the float32 softmax, the weights to
bfloat16 once normalised, the float32 weighted sum rounded once to
bfloat16); only the order of its float32 sums differs from the library
products'.  A different order moves a score or the softmax's sum by a
few float32 ulps, which flips a weight's bfloat16 rounding only where it
lay within that of a midpoint, and moves the float32 output before its one
rounding.  So most outputs are equal or one bfloat16 ulp apart (at least
99 % within 1 ulp of their magnitude), and the worst is bounded by one
ulp plus the flipped weights' share, at most 2^-7 of every weight, of
``sum_j w_j |v_j|``, the output's magnitude before cancellation."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as da
from repro_torch.models import attention


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the decode-attention kernel runs "
                    "only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(dev, B, S, Kv, G, D, pos, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, 1, Kv, G, D), generator=gen, device=dev)
    k = torch.randn((B, S, Kv, D), generator=gen, device=dev)
    v = torch.randn((B, S, Kv, D), generator=gen, device=dev)
    pos = torch.as_tensor(pos, dtype=torch.long, device=dev)
    return (q.to(torch.bfloat16), k.to(torch.bfloat16), v.to(torch.bfloat16),
            pos)


def _plain(q, k, v, pos, scale):
    """``attend_full`` as ``gqa_decode`` calls it on a full cache."""
    j = torch.arange(k.shape[1], device=k.device)[None, :]
    kv_pos = torch.where(j <= pos[:, None], j, -1)
    kv_pos = torch.where(kv_pos >= 0, kv_pos, -1)
    return attention.attend_full(q, k, v, pos[:, None], kv_pos, window=None,
                                 scale=scale)


def _bf16_ulp(x):
    """One bfloat16 ulp at |x| (8 significant bits), for normal values."""
    a = x.abs().float().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _check_close(got, want, q, k, v, pos, scale):
    """The module's tolerance; returns (share within 1 ulp, worst error
    over its bound)."""
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    ulp = _bf16_ulp(want)
    within = float((err <= ulp).float().mean())
    mag = _plain(q, k, v.abs(), pos, scale).float()
    bound = ulp + 2.0 ** -7 * mag
    worst = float((err / bound).max())
    assert torch.isfinite(got.float()).all()
    assert within >= 0.99, within
    assert worst <= 1.0, worst
    return within, worst


CELL = dict(B=32, S=1280, Kv=32, G=1, D=64)  # the LM serving cell's decode


def _cell_pos(case):
    B, S = CELL["B"], CELL["S"]
    if case == "mixed":
        rng = np.random.default_rng(7)
        # rows at the edges, inside and past the cache, in one batch
        fixed = [0, 1, 1023, 1024, S - 2, S - 1, S, S + 300]
        return fixed + list(rng.integers(0, S + 64, B - len(fixed)))
    return [int(case)] * B


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["0", "1023", "1279", "1280", "4096",
                                  "mixed"])
def test_kernel_matches_attend_full_at_the_cell_shape(cuda_device, case):
    q, k, v, pos = _inputs(cuda_device, **CELL, pos=_cell_pos(case))
    scale = CELL["D"] ** -0.5
    got = da.decode_attention(q, k, v, pos, scale)
    want = _plain(q, k, v, pos, scale)
    _check_close(got, want, q, k, v, pos, scale)
    if case == "0":
        # one valid row: its weight is exactly 1, so o is that row of v
        assert torch.equal(got[:, 0], v[:, 0].unsqueeze(2).expand_as(got[:, 0]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    dict(B=4, S=1024, Kv=8, G=7, D=128),  # yi-34b's heads
    dict(B=4, S=700, Kv=32, G=1, D=96),  # phi-3-vision's
    dict(B=3, S=512, Kv=16, G=2, D=64),  # granite-moe's
    dict(B=2, S=4096, Kv=8, G=8, D=128),  # the largest group, scores 128 KB
], ids=["d128-g7", "d96-g1", "d64-g2", "d128-g8-s4096"])
def test_kernel_matches_attend_full_at_the_zoo_shapes(cuda_device, shape):
    B, S = shape["B"], shape["S"]
    pos = [S // 3 + 17 * i for i in range(B - 1)] + [S - 1]
    q, k, v, pos = _inputs(cuda_device, **shape, pos=pos, seed=1)
    scale = shape["D"] ** -0.5
    got = da.decode_attention(q, k, v, pos, scale)
    _check_close(got, _plain(q, k, v, pos, scale), q, k, v, pos, scale)


@pytest.mark.cuda
def test_a_row_with_no_valid_position_weighs_every_row_alike(cuda_device):
    """pos < 0: every score is masked, and attend_full's softmax of equal
    scores weighs all S rows 1 / S; the kernel does the same."""
    q, k, v, pos = _inputs(cuda_device, B=2, S=256, Kv=4, G=2, D=64,
                           pos=[-1, 100])
    got = da.decode_attention(q, k, v, pos, 0.125)
    _check_close(got, _plain(q, k, v, pos, 0.125), q, k, v, pos, 0.125)


@pytest.mark.cuda
def test_graphed_replay_equals_eager_and_runs_repeat(cuda_device):
    q, k, v, pos = _inputs(cuda_device, **CELL, pos=_cell_pos("mixed"))
    scale = CELL["D"] ** -0.5
    fn = da.decode_attention
    before = (fn.launches, fn.captured)
    eager = fn(q, k, v, pos, scale)
    again = fn(q, k, v, pos, scale)
    assert torch.equal(eager, again)  # deterministic: bit for bit
    assert (fn.launches, fn.captured) == (before[0] + 2, before[1])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = fn(q, k, v, pos, scale)
    assert (fn.launches, fn.captured) == (before[0] + 2, before[1] + 1)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(static, eager)
    # the replay reads pos on the device: move every row one step on
    pos.add_(1)
    graph.replay()
    moved = fn(q, k, v, pos, scale)
    torch.cuda.synchronize()
    assert torch.equal(static, moved)
    assert fn.captured == before[1] + 1  # a replay launches, not captures


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    q, k, v, pos = _inputs(cuda_device, B=2, S=64, Kv=4, G=1, D=64,
                           pos=[3, 5])
    with pytest.raises(ValueError, match="contiguous"):
        da.decode_attention(q, k[:, ::2], v[:, ::2], pos, 0.125)
    with pytest.raises(ValueError, match="does not take"):
        q2, k2, v2, _ = _inputs(cuda_device, B=2, S=64, Kv=4, G=1, D=32,
                                pos=[3, 5])
        da.decode_attention(q2, k2, v2, pos, 0.125)
    with pytest.raises(TypeError, match="bfloat16"):
        da.decode_attention(q.float(), k, v, pos, 0.125)


def _serve_model(dev):
    from repro_torch import configs
    from repro_torch.models.model import Model

    cfg = configs.get("stablelm-1.6b")  # 24 layers, 32 heads of 64, bf16
    model = Model(cfg)
    return cfg, model, model.init(0, dev)


@pytest.mark.cuda
def test_serving_engine_decode_runs_the_kernel_and_keeps_greedy_tokens(
        cuda_device):
    """stablelm-1.6b at full width, bfloat16 compute, through the graphed
    ``ServeEngine``: the decode capture records one launch a layer and no
    fallback, and the graphed tokens equal the eager engine's.  Then the
    float32 gate: the same params in float32 compute (TF32 off; its decode
    never takes the kernel) run teacher-forced over each prompt and its
    served tokens, and at every generated position the served token's
    logit lies within 0.1 of the best (the serving cell's
    ``served_logit_gap`` limit; bfloat16 serving reads up to ~0.05)."""
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import Request, ServeEngine

    cfg, model, params = _serve_model(cuda_device)
    rng = np.random.default_rng(3)
    P, N = 40, 12
    reqs = [Request(prompt=rng.integers(0, cfg.vocab_size, P).astype(np.int32),
                    max_new_tokens=N) for _ in range(4)]
    fn = da.decode_attention
    fn.launches = fn.captured = fn.fallbacks = 0
    eng = ServeEngine(model, params, batch_size=4, cache_len=64)
    outs = eng.generate(reqs)
    assert eng._decode._cache_size() == 1
    assert fn.captured == cfg.num_layers  # one launch a layer, recorded once
    assert fn.launches == cfg.num_layers  # the signature's first, eager call
    assert fn.fallbacks == 0
    eager = ServeEngine(model, params, batch_size=4, cache_len=64,
                        cuda_graph=False).generate(reqs)
    assert all(np.array_equal(a, b) for a, b in zip(outs, eager))
    # the eager engine launches once a layer and step, and captures nothing
    eager_steps = (fn.launches - cfg.num_layers) / cfg.num_layers
    assert eager_steps in (N - 1, N) and fn.captured == cfg.num_layers
    assert fn.fallbacks == 0
    del eng

    gate = Model(dataclasses.replace(cfg, dtype="float32"))
    tokens = torch.as_tensor(np.stack([np.concatenate([r.prompt, o])
                                       for r, o in zip(reqs, outs)])
                             ).to(cuda_device)
    with torch.no_grad():
        logits = gate.forward_logits(params, {"tokens": tokens}).float()
    pred = logits[:, P - 1: P - 1 + N]  # predicts the served token j
    served = torch.gather(pred, -1, tokens[:, P:, None])[..., 0]
    gaps = pred.max(-1).values - served
    assert float(gaps.max()) <= 0.1, float(gaps.max())


@pytest.mark.cuda
def test_float32_decode_on_the_card_falls_back(cuda_device):
    """The float32 gate's precision is not the kernel's: its decode calls
    run attend_full and are counted as fallbacks, one a layer and step."""
    from repro_torch import configs
    from repro_torch.models.model import Model

    cfg = dataclasses.replace(configs.get("stablelm-1.6b").reduced(),
                              head_dim=64)
    model = Model(cfg)
    params = model.init(0, cuda_device)
    fn = da.decode_attention
    fn.launches = fn.captured = fn.fallbacks = 0
    toks = torch.zeros((2, 8), dtype=torch.long, device=cuda_device)
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": toks}, 16)
        pos = torch.full((2,), 8, dtype=torch.long, device=cuda_device)
        model.decode_step(params, toks[:, :1], pos, cache)
    assert (fn.launches, fn.fallbacks) == (0, cfg.num_layers)
