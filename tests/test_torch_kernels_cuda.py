"""The CUDA kernels (``snn_chunk``, ``aer_spike_matmul_batched``,
``aer_spike_matmul``, ``lif_fused``, ``spike_matmul``, ``q115_matmul``)
against their plain PyTorch versions, on the card.  Imports neither JAX nor the reference, so it runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Without a CUDA device every test here skips."""

import numpy as np
import pytest
import torch

from repro_torch.core import neuron, snn
from repro_torch.events import runtime
from repro_torch.kernels import _build
from repro_torch.kernels import aer_matmul as aer_mod
from repro_torch.kernels import lif_fused as lif_mod
from repro_torch.kernels import ops, ref
from repro_torch.kernels import q115_matmul as q115_mod
from repro_torch.kernels import snn_chunk as chunk_mod

CASES = ["zero", "subtract", "refractory", "lapicque", "q115", "frozen",
         "time_major", "int32_float", "three_layers"]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(case, dev):
    rng = np.random.default_rng(CASES.index(case))
    sizes = (256, 96, 40, 2) if case == "three_layers" else (256, 64, 2)
    cfg = snn.SNNConfig(
        layer_sizes=sizes, num_steps=5, quant_q115=case == "q115",
        reset="subtract" if case == "subtract" else "zero",
        refractory_steps=3 if case == "refractory" else 0,
        neuron_kind="lapicque" if case == "lapicque" else "lif",
    )
    params = runtime.prepare_params(
        snn.init_params(torch.Generator().manual_seed(1), cfg, dev), cfg
    )
    for lp in params.values():
        lp["threshold"].fill_(0.3)
    B = 6
    x = (rng.random((B, 5, sizes[0])) < 0.4).astype(np.float32)
    x[:, 3] = 0.0  # an all-silent step
    tab = runtime.encode_step_table(torch.from_numpy(x).to(dev), sizes[0])
    a, v, c = tab
    layout = "slot_major"
    if case == "int32_float":
        a, v = a.to(torch.int32), v.to(torch.float32)
    if case == "time_major":
        layout = "time_major"
        a, v, c = (a.transpose(0, 1).contiguous(),
                   v.transpose(0, 1).contiguous(), c.T.contiguous())
    states = [
        neuron.NeuronState(
            torch.from_numpy(rng.normal(0, 0.3, (B, n)).astype(np.float32)).to(dev),
            torch.from_numpy(rng.integers(0, 3, (B, n)).astype(np.int32)).to(dev),
        )
        for n in sizes[1:]
    ]
    act = torch.ones(B, device=dev)
    if case == "frozen":
        act[2] = 0
    return params, states, a, v, c, cfg, act, layout


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain_version_on_card(cuda_device, case):
    params, states, a, v, c, cfg, act, layout = _inputs(case, cuda_device)
    args = (params, states, a, v, c, cfg)
    before = chunk_mod.snn_chunk.launches
    got = runtime.run_chunk_events(*args, active=act, backend="fused",
                                   layout=layout, prepared=True)
    assert chunk_mod.snn_chunk.launches == before + 1
    ref = runtime.run_chunk_events(*args, active=act, backend="fused_ref",
                                   layout=layout, prepared=True)
    torch.cuda.synchronize()
    assert got[2].sum() > 0 or case == "frozen"
    for x, y in zip(got[1:], ref[1:]):
        assert torch.equal(x, y)
    for s, r in zip(got[0], ref[0]):
        assert torch.equal(s.u, r.u) and torch.equal(s.refrac, r.refrac)
    if case == "frozen":
        assert not got[2][:, 2].any() and not got[3][:, :, 2].any()
        for s, st in zip(got[0], states):
            assert torch.equal(s.u[2], st.u[2])


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take(cuda_device):
    params, states, a, v, c, cfg, act, layout = _inputs("zero", cuda_device)
    lp = [params[f"layer{i}"] for i in range(2)]
    args = ([p["w"] for p in lp], [p["b"] for p in lp],
            [snn.effective_beta(p) for p in lp], [p["threshold"] for p in lp],
            [s.u for s in states], [s.refrac for s in states])
    with pytest.raises(TypeError, match="int16 or int32"):
        chunk_mod.snn_chunk(*args, a.to(torch.int64), v, c, act, layout=layout)
    with pytest.raises(ValueError, match="device"):
        chunk_mod.snn_chunk(*args, a, v, c, act.cpu(), layout=layout)
    # 75,000 columns a CTA: their state alone exceeds a block's shared memory
    wide = 600000
    big = [torch.zeros(64, wide, device=cuda_device)]
    with pytest.raises(ValueError, match="shared memory"):
        chunk_mod.snn_chunk(big, [torch.zeros(wide, device=cuda_device)] * 1,
                            [torch.zeros(wide, device=cuda_device)],
                            [torch.zeros(wide, device=cuda_device)],
                            [torch.zeros(6, wide, device=cuda_device)],
                            [torch.zeros(6, wide, dtype=torch.int32,
                                         device=cuda_device)],
                            (a % 64), v, c, act, layout=layout)


def _chunk_args(sizes, B, Tc, dev, *, layout, int32_float=False, seed=0):
    """Seeded inputs of ``snn_chunk`` at collision-like rates: a frozen
    slot (when B > 1), a silent step (when Tc > 2), random state."""
    rng = np.random.default_rng(seed)
    ws = [torch.from_numpy(rng.uniform(-1, 1, (k, n)).astype(np.float32)
                           / np.sqrt(k)).to(dev)
          for k, n in zip(sizes[:-1], sizes[1:])]

    def vec(n, lo, hi):
        return torch.from_numpy(rng.uniform(lo, hi, n).astype(np.float32)).to(dev)

    biases = [vec(n, -0.05, 0.05) for n in sizes[1:]]
    betas = [vec(n, 0.8, 0.95) for n in sizes[1:]]
    thrs = [vec(n, 0.1, 0.3) for n in sizes[1:]]
    u0 = [torch.from_numpy(rng.normal(0, 0.2, (B, n)).astype(np.float32)).to(dev)
          for n in sizes[1:]]
    r0 = [torch.from_numpy(rng.integers(0, 3, (B, n)).astype(np.int32)).to(dev)
          for n in sizes[1:]]
    x = (rng.random((B, Tc, sizes[0])) < 0.3).astype(np.float32)
    if Tc > 2:
        x[:, 2] = 0.0  # an all-silent step
    a, v, c = runtime.encode_step_table(torch.from_numpy(x).to(dev), sizes[0])
    if int32_float:
        a, v = a.to(torch.int32), v.to(torch.float32)
    if layout == "time_major":
        a, v, c = (a.transpose(0, 1).contiguous(),
                   v.transpose(0, 1).contiguous(), c.T.contiguous())
    act = torch.ones(B, device=dev)
    if B > 1:
        act[B // 2] = 0  # a frozen slot
    return (ws, biases, betas, thrs, u0, r0, a, v, c, act)


CHUNK_SHAPES = [
    # sizes, B, Tc, layout, int32 addresses with float32 values
    ((4096, 512, 2), 1, 1, "slot_major", False),
    ((4096, 512, 2), 8, 5, "slot_major", False),
    ((4096, 512, 2), 9, 5, "time_major", True),
    ((4096, 512, 2), 32, 25, "slot_major", False),
    ((4096, 500, 2), 8, 5, "time_major", False),
    ((256, 300, 40, 2), 9, 5, "slot_major", True),
    ((256, 300, 40, 2), 8, 25, "time_major", False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CHUNK_SHAPES)
@pytest.mark.parametrize("kw", [{}, {"refractory_steps": 3, "reset": "subtract"}])
def test_kernel_matches_plain_version_at_cluster_shapes(cuda_device, shape, kw):
    sizes, B, Tc, layout, int32_float = shape
    args = _chunk_args(sizes, B, Tc, cuda_device, layout=layout,
                       int32_float=int32_float, seed=B * Tc)
    got = _launched(chunk_mod.snn_chunk, *args, layout=layout, **kw)
    exp = chunk_mod.snn_chunk_ref(*args, layout=layout, **kw)
    torch.cuda.synchronize()
    assert got[2][:, 0].sum() > 0 and got[2][:, 1].sum() > 0
    for x, y in zip(got[:3], exp[:3]):
        assert torch.equal(x, y)
    for x, y in zip(got[3] + got[4], exp[3] + exp[4]):
        assert torch.equal(x, y)


def _aer_inputs(B, E, K, N, rate, int16, dev, seed=0, kind="random"):
    """(addrs, values, weights) on ``dev``.  ``kind``: "random" (live
    events anywhere, corrupt addresses, the last stream silent), "repeats"
    (unsorted addresses, each stream hitting a few rows many times),
    "sorted" (the tables ``runtime.step_events`` builds from a random
    plane: live first, ascending addresses), "wrap" (int16 sums past
    -2^31)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, K, (B, E)).astype(np.int32)
    if kind == "repeats":
        a = rng.choice(rng.integers(0, K, 5), (B, E)).astype(np.int32)
    a[0, :4] = [-1, K, K + 9, 0][:E]  # corrupt addresses are skipped
    v = np.where(rng.random((B, E)) < rate,
                 rng.choice([-1.0, 1.0, 0.5], (B, E)), 0.0).astype(np.float32)
    v[-1] = 0.0  # a stream with no event
    if kind == "sorted":
        plane = (rng.random((B, K)) < rate) * rng.choice([-1.0, 1.0], (B, K))
        plane[-1] = 0.0
        at, vt, _ = runtime.step_events(torch.from_numpy(plane.astype(np.float32)), E)
        a, v = at.numpy(), vt.numpy()
    if int16:
        w = rng.integers(-32768, 32768, (K, N)).astype(np.int16)
        v = np.rint(v).astype(np.int32)
        if kind == "wrap":
            w[:] = -32768
            v = np.where(v != 0, 2**20 + 7, 0).astype(np.int32)
    else:
        w = rng.normal(0, 0.05, (K, N)).astype(np.float32)
    return (torch.from_numpy(a).to(dev), torch.from_numpy(v).to(dev),
            torch.from_numpy(w).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("int16", [False, True])
@pytest.mark.parametrize("shape", [(32, 4096, 4096, 512, 0.9),
                                   (32, 4096, 4096, 512, 0.01),
                                   (32, 512, 512, 2, 0.2),
                                   (5, 300, 77, 200, 0.3),
                                   # both sides of the narrow variant
                                   *((6, 97, 300, n, 0.5) for n in (1, 2, 31, 32, 33)),
                                   (3, 4096, 4096, 512, 1.0),  # 4,096 live a stream
                                   (4, 1, 5, 64, 1.0),  # one event
                                   (4, 0, 5, 64, 1.0),  # no event at all
                                   (2, 130, 129, 129, 0.7),
                                   (2, 300, 60000, 64, 0.5)])  # the "rows" ring
@pytest.mark.parametrize("kind", ["random", "repeats", "sorted"])
def test_aer_kernel_matches_plain_version_on_card(cuda_device, int16, shape, kind):
    a, v, w = _aer_inputs(*shape, int16, cuda_device, kind=kind)
    before = aer_mod.aer_spike_matmul_batched.launches
    got = aer_mod.aer_spike_matmul_batched(a, v, w)
    assert aer_mod.aer_spike_matmul_batched.launches == before + 1
    ref = aer_mod.aer_spike_matmul_batched_ref(a, v, w)
    torch.cuda.synchronize()
    assert got.dtype == (torch.int32 if int16 else torch.float32)
    assert torch.equal(got, ref)
    assert not got[-1].any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 4096, 4096, 512, 0.9), (3, 700, 64, 2, 1.0)])
def test_aer_kernel_int16_sums_wrap_on_card(cuda_device, shape):
    a, v, w = _aer_inputs(*shape, True, cuda_device, kind="wrap")
    live = ((v != 0) & (a >= 0) & (a < w.shape[0])).sum(1).long().cpu()
    got = _launched(aer_mod.aer_spike_matmul_batched, a, v, w)
    assert torch.equal(got, aer_mod.aer_spike_matmul_batched_ref(a, v, w))
    want = (live * (2**20 + 7) * -32768 + 2**31) % 2**32 - 2**31
    assert live.max() * (2**20 + 7) * 32768 > 2**31  # the sum does wrap
    assert torch.equal(got.cpu(), want[:, None].expand(-1, w.shape[1]).to(torch.int32))


@pytest.mark.cuda
def test_aer_kernel_reads_live_events_after_padding_on_card(cuda_device):
    # padding first, then live events, a silent E-block between two live ones
    a, v, w = _aer_inputs(6, 900, 4096, 512, 1.0, False, cuda_device, seed=3)
    v[:, :200] = 0.0
    v[:, 256:384] = 0.0
    v[2, :-1] = 0.0  # one live event, the very last
    v[2, -1] = 1.0
    for x in (v, v.to(torch.int32)):
        ww = w if x.dtype == torch.float32 else (w * 1000).to(torch.int16)
        got = _launched(aer_mod.aer_spike_matmul_batched, a, x, ww)
        assert torch.equal(got, aer_mod.aer_spike_matmul_batched_ref(a, x, ww))
        assert got[2].any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 4096, 4096, 512, False),
                                   (32, 512, 512, 2, False),
                                   (2, 300, 60000, 64, False),
                                   (1, 4096, 4096, 512, True)])
def test_aer_kernel_launches_the_planned_variant_on_card(cuda_device, shape):
    from torch.profiler import ProfilerActivity, profile

    B, E, K, N, int16 = shape
    a, v, w = _aer_inputs(B, E, K, N, 0.5, int16, cuda_device)
    geo = aer_mod.plan(B, E, K, N, int16)
    aer_mod.aer_spike_matmul_batched(a, v, w)  # build, warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        aer_mod.aer_spike_matmul_batched(a, v, w)
        torch.cuda.synchronize()
    names = {ev.key for ev in prof.key_averages() if "aer_" in ev.key}
    if not names:
        pytest.skip("the profiler recorded no kernel on this machine")
    assert any(f"aer_{geo.variant}_kernel" in n for n in names), names
    assert not any(f"aer_{other}_kernel" in n for n in names
                   for other in aer_mod.VARIANTS if other != geo.variant)


@pytest.mark.cuda
def test_aer_kernel_rejects_what_it_cannot_take(cuda_device):
    a, v, w = _aer_inputs(4, 64, 32, 8, 0.5, False, cuda_device)
    fn = aer_mod.aer_spike_matmul_batched
    with pytest.raises(TypeError, match="int32"):
        fn(a.long(), v, w)
    with pytest.raises(TypeError, match="float32 values"):
        fn(a, v.to(torch.int32), w)
    with pytest.raises(TypeError, match="int16 or float32"):
        fn(a, v, w.half())
    with pytest.raises(ValueError, match="values"):
        fn(a, v[:, :10], w)
    with pytest.raises(ValueError, match=r"\(B, E\)"):
        fn(a[0], v[0], w)
    with pytest.raises(ValueError, match="device"):
        fn(a, v, w.cpu())


def _launched(fn, *args, **kw):
    """Call a kernel wrapper and check that it launched exactly once."""
    before = fn.launches
    out = fn(*args, **kw)
    assert fn.launches == before + 1
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(25, 8, 512), (25, 8, 2), (7, 3, 130),
                                   (1, 1, 1)])
@pytest.mark.parametrize("refractory", [0, 5])
@pytest.mark.parametrize("reset", ["zero", "subtract"])
def test_lif_kernel_matches_plain_version_on_card(cuda_device, shape,
                                                   refractory, reset):
    rng = np.random.default_rng(sum(shape))
    T, B, N = shape
    cur = torch.from_numpy(rng.normal(0.3, 0.7, shape).astype(np.float32))
    beta = torch.from_numpy(rng.uniform(0.5, 0.99, N).astype(np.float32))
    thr = torch.from_numpy(rng.uniform(0.5, 1.5, N).astype(np.float32))
    cur[0, 0, 0] = float("inf")  # propagates through the reset multiply
    args = [x.to(cuda_device) for x in (cur, beta, thr)]
    kw = dict(refractory_steps=refractory, reset=reset)
    spk, u = _launched(ops.lif_fused, *args, **kw)
    r_spk, r_u = ref.lif_fused_ref(*args, **kw)
    assert torch.equal(spk, r_spk)
    assert torch.equal(u.isnan(), r_u.isnan())
    assert torch.equal(u.nan_to_num(), r_u.nan_to_num())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(200, 4096, 512), (200, 512, 2),
                                   (37, 513, 129), (1, 1, 1)])
def test_spike_matmul_kernel_matches_plain_version_on_card(cuda_device, shape):
    M, K, N = shape
    rng = np.random.default_rng(M + K)
    spk = (rng.random((M, K)) < 0.2).astype(np.int8)
    spk[:, : K // 2] = 0  # silent slabs are skipped
    spk[-1, -1] = -3  # an integer spike multiplies
    w = rng.integers(-(2**15), 2**15, (K, N)).astype(np.int16)
    s, w = torch.from_numpy(spk).to(cuda_device), torch.from_numpy(w).to(cuda_device)
    got = _launched(ops.spike_matmul, s, w)
    assert got.dtype == torch.int32
    assert torch.equal(got, ref.spike_matmul_ref(s, w))


def _spikes_weights(kind, M, K, N, dev):
    rng = np.random.default_rng(M * 7 + K + N)
    spk = (rng.random((M, K)) < 0.3).astype(np.int8)
    w = rng.integers(-(2**15), 2**15, (K, N)).astype(np.int16)
    if kind == "overflow":  # 4096 x 127 x -32768 passes -2^31: must wrap
        spk[:], w[:] = 127, -(2**15)
    elif kind == "extremes":
        spk[rng.random((M, K)) < 0.1] = -128
        w[rng.random((K, N)) < 0.2] = -(2**15)
        w[rng.random((K, N)) < 0.2] = 2**15 - 1
    elif kind == "silent":
        spk[:] = 0
    return (torch.from_numpy(spk).to(dev), torch.from_numpy(w).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,shape", [
    ("overflow", (200, 4096, 512)), ("overflow", (37, 4096, 2)),
    ("extremes", (200, 4096, 512)), ("extremes", (37, 100, 129)),
    ("extremes", (1, 513, 2)), ("extremes", (200, 4095, 129)),
    ("random", (200, 512, 2)), ("random", (37, 4096, 512)),
    ("random", (1, 4096, 512)), ("random", (129, 77, 64)),
    ("silent", (200, 4096, 512)), ("silent", (37, 513, 129)),
])
def test_spike_matmul_kernel_edges_on_card(cuda_device, kind, shape):
    s, w = _spikes_weights(kind, *shape, cuda_device)
    got = _launched(ops.spike_matmul, s, w)
    exp = ref.spike_matmul_ref(s, w)
    assert torch.equal(got, exp)
    if kind == "overflow":
        assert int(exp[0, 0]) == (4096 * 127 * -(2**15) + 2**31) % 2**32 - 2**31
    if kind == "silent":
        assert not got.any()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 512, 128), (200, 4096, 512),
                                   (33, 129, 65), (16, 4096, 8)])
@pytest.mark.parametrize("saturate", [True, False])
def test_q115_kernel_matches_plain_version_on_card(cuda_device, shape, saturate):
    M, K, N = shape
    rng = np.random.default_rng(M * N)
    x = rng.integers(-(2**15), 2**15, (M, K)).astype(np.int16)
    w = rng.integers(-(2**15), 2**15, (K, N)).astype(np.int16)
    x[0], w[:, 0] = -(2**15), -(2**15)
    x, w = torch.from_numpy(x).to(cuda_device), torch.from_numpy(w).to(cuda_device)
    got = _launched(ops.q115_matmul, x, w, saturate=saturate)
    plain = ref.q115_matmul_ref if saturate else ref.q115_matmul_acc_ref
    assert torch.equal(got, plain(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("K,N,rate", [(4096, 512, 0.3), (512, 2, 0.5),
                                      (257, 129, 1.0), (64, 32, 0.0),
                                      (4096, 512, 1.0),  # 4,096 live events
                                      *((300, n, 0.5) for n in (1, 2, 31, 32, 33))])
def test_aer_single_kernel_matches_plain_and_dense_on_card(cuda_device, K, N, rate):
    rng = np.random.default_rng(K + N)
    row = (rng.random(K) < rate).astype(np.int8)
    idx = np.nonzero(row)[0]
    a = np.zeros(K + 5, np.int32)
    v = np.zeros(K + 5, np.int32)
    a[: len(idx)], v[: len(idx)] = idx, 1
    w = torch.from_numpy(rng.integers(-(2**15), 2**15, (K, N)).astype(np.int16)).to(cuda_device)
    a, v = torch.from_numpy(a).to(cuda_device), torch.from_numpy(v).to(cuda_device)
    before = aer_mod.aer_spike_matmul_batched.launches
    got = _launched(ops.aer_spike_matmul, a, v, w)
    assert aer_mod.aer_spike_matmul_batched.launches == before
    assert torch.equal(got, ref.aer_spike_matmul_ref(a, v, w))
    dense = ref.spike_matmul_ref(torch.from_numpy(row[None]).to(cuda_device), w)[0]
    assert torch.equal(got, dense)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["random", "repeats", "sorted", "wrap"])
@pytest.mark.parametrize("E,N", [(4096, 512), (1000, 2), (97, 33), (0, 8), (1, 31)])
def test_aer_single_kernel_edges_on_card(cuda_device, kind, E, N):
    a, v, w = _aer_inputs(2, E, 4096, N, 0.5, True, cuda_device, seed=E + N,
                          kind=kind)
    a, v = a[0], v[0].to(torch.int8 if kind != "wrap" else torch.int32)
    if kind != "random":  # live events after padding, in any order
        v[: E // 3] = 0
    got = _launched(ops.aer_spike_matmul, a, v, w)
    assert torch.equal(got, ref.aer_spike_matmul_ref(a, v, w))


@pytest.mark.cuda
def test_new_kernels_reject_what_they_cannot_take(cuda_device):
    d = cuda_device
    cur, beta, thr = torch.zeros(3, 2, 4, device=d), torch.ones(4, device=d), torch.ones(4, device=d)
    with pytest.raises(ValueError, match="reset"):
        ops.lif_fused(cur, beta, thr, reset="hard")
    with pytest.raises(TypeError, match="float32"):
        ops.lif_fused(cur.double(), beta, thr)
    with pytest.raises(ValueError, match="device"):
        ops.lif_fused(cur, beta.cpu(), thr)
    with pytest.raises(ValueError, match=r"\(4,\)"):
        ops.lif_fused(cur, beta[:3], thr)
    s8 = torch.zeros(4, 8, dtype=torch.int8, device=d)
    w16 = torch.zeros(8, 3, dtype=torch.int16, device=d)
    with pytest.raises(TypeError, match="int8"):
        ops.spike_matmul(s8.float(), w16)
    with pytest.raises(ValueError, match="device"):
        ops.spike_matmul(s8, w16.cpu())
    with pytest.raises(ValueError, match=r"\(K, N\)"):
        ops.spike_matmul(s8, w16[:7])
    x16 = torch.zeros(4, 8, dtype=torch.int16, device=d)
    with pytest.raises(TypeError, match="int16"):
        ops.q115_matmul(s8, w16)
    with pytest.raises(ValueError, match="device"):
        ops.q115_matmul(x16, w16.cpu())
    with pytest.raises(ValueError, match=r"\(K, N\)"):
        ops.q115_matmul(x16, w16[:7], saturate=False)
    a = torch.zeros(4, dtype=torch.int32, device=d)
    v = torch.ones(4, dtype=torch.int32, device=d)
    with pytest.raises(TypeError, match="integer"):
        ops.aer_spike_matmul(a, v.float(), w16)
    with pytest.raises(TypeError, match="int16"):
        ops.aer_spike_matmul(a, v, w16.float())
    with pytest.raises(ValueError, match="device"):
        ops.aer_spike_matmul(a, v, w16.cpu())
    with pytest.raises(ValueError, match=r"\(E,\)"):
        ops.aer_spike_matmul(a[None], v[None], w16)


# ------------------------------------------ q115_matmul: split-K and edges
def _q115_case(kind, M, K, N, dev):
    rng = np.random.default_rng(M * 31 + K + N)
    x = rng.integers(-(2**15), 2**15, (M, K)).astype(np.int16)
    w = rng.integers(-(2**15), 2**15, (K, N)).astype(np.int16)
    if kind == "extremes":  # the extreme codes, whose square is 2^30
        x[rng.random((M, K)) < 0.3] = -(2**15)
        w[rng.random((K, N)) < 0.3] = -(2**15)
        w[rng.random((K, N)) < 0.2] = 2**15 - 1
    return torch.from_numpy(x).to(dev), torch.from_numpy(w).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("saturate", [True, False])
@pytest.mark.parametrize("kind,shape", [
    ("random", (1, 512, 128)),  # M = 1
    ("random", (128, 512, 1)),  # N = 1
    ("random", (1, 1, 1)),
    ("random", (37, 33, 129)),  # K past a 32-k slab, K and N not 8-aligned
    ("random", (64, 1000, 65)),  # K not a multiple of the slab
    ("random", (200, 4100, 512)),  # the large shape with K past whole slabs
    ("random", (5, 0, 7)),  # K = 0: zeros
    ("extremes", (130, 4096, 128)),
    ("extremes", (200, 4096, 512)),
])
def test_q115_kernel_edges_on_card(cuda_device, kind, shape, saturate):
    x, w = _q115_case(kind, *shape, cuda_device)
    got = _launched(ops.q115_matmul, x, w, saturate=saturate)
    plain = ref.q115_matmul_ref if saturate else ref.q115_matmul_acc_ref
    assert torch.equal(got, plain(x, w))


@pytest.mark.cuda
@pytest.mark.parametrize("saturate", [True, False])
def test_q115_kernel_sums_wrap_int32_on_card(cuda_device, saturate):
    """2^16 + 8 maximal rounded products, (2^30 + 2^14) >> 15 = 2^15 each,
    sum to 2^31 + 2^18, which wraps to -2^31 + 2^18 over many K splits."""
    K = 2**16 + 8
    x = torch.full((3, K), -(2**15), dtype=torch.int16, device=cuda_device)
    w = torch.full((K, 9), -(2**15), dtype=torch.int16, device=cuda_device)
    assert q115_mod.plan(3, K, 9, saturate).split > 1
    got = _launched(ops.q115_matmul, x, w, saturate=saturate)
    want = -(2**31) + 2**18
    assert int(ref.q115_matmul_acc_ref(x, w)[0, 0]) == want
    assert (got == (-(2**15) if saturate else want)).all()


@pytest.mark.cuda
def test_q115_kernel_saturates_only_the_whole_sum_on_card(cuda_device):
    """Partials of the K splits leave int16 while the whole sum does not,
    and partials inside int16 add up to a sum that saturates."""
    d, M, K, N = cuda_device, 4, 512, 8
    geo = q115_mod.plan(M, K, N, saturate=True)
    assert geo.split > 1 and geo.cluster == geo.split
    # rows 0-1: every rounded product +32766 in the first half of K, -32767
    # in the second: each split's partial leaves int16, the sum is -256
    x = torch.full((M, K), 2**15 - 1, dtype=torch.int16, device=d)
    w = torch.full((K, N), 2**15 - 1, dtype=torch.int16, device=d)
    w[K // 2:] = -(2**15)
    # rows 2-3: every product 128, 8,192 a split of 64, 65,536 in all
    x[2:] = 2048
    w16 = torch.full((K, N), 2048, dtype=torch.int16, device=d)
    raw = ref.q115_matmul_acc_ref(x, w)
    part = ref.q115_matmul_acc_ref(x[:, :geo.k_per_split], w[:geo.k_per_split])
    assert int(raw[0, 0]) == -256 and int(part[0, 0]) > 2**15
    got = _launched(ops.q115_matmul, x, w)
    assert torch.equal(got, ref.q115_matmul_ref(x, w))
    assert int(got[0, 0]) == -256
    got16 = _launched(ops.q115_matmul, x[2:], w16)
    assert int(ref.q115_matmul_acc_ref(x[2:, :geo.k_per_split],
                                       w16[:geo.k_per_split])[0, 0]) < 2**15
    assert (got16 == 2**15 - 1).all()


# ------------------------------------------- lif_fused: both input forms
def _lif_case(T, B, N, dev, seed):
    rng = np.random.default_rng(seed)
    cur = rng.normal(0.3, 0.7, (T, B, N)).astype(np.float32)
    acc = rng.integers(-(2**15), 2**16, (T, B, N)).astype(np.int32)
    bias = rng.integers(-(2**15), 2**15, N).astype(np.int32)
    beta = rng.uniform(0.5, 0.99, N).astype(np.float32)
    thr = rng.uniform(0.5, 1.5, N).astype(np.float32)
    cur[0, 0, 0] = np.inf  # propagates through the reset multiply
    acc[0, 0, 0], bias[0] = 2**31 - 5, 2**15 - 1  # the bias add wraps
    acc[-1, -1, -1] = 2**24 + 1  # rounds in the conversion
    return [torch.from_numpy(a).to(dev) for a in (cur, acc, bias, beta, thr)]


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 25, 100])
@pytest.mark.parametrize("form", ["float", "int32"])
@pytest.mark.parametrize("refractory", [0, 5])
@pytest.mark.parametrize("reset", ["zero", "subtract"])
def test_lif_kernel_forms_over_time_blocks_on_card(cuda_device, T, form,
                                                   refractory, reset):
    """T = 100 walks four blocks of the kernel's 32 steps in registers."""
    B, N = (8, 512) if T == 25 else (3, 130)
    cur, acc, bias, beta, thr = _lif_case(T, B, N, cuda_device, T + B)
    kw = dict(refractory_steps=refractory, reset=reset)
    if form == "float":
        fn, plain, args = ops.lif_fused, ref.lif_fused_ref, (cur, beta, thr)
    else:
        fn, plain = lif_mod.lif_fused_from_acc, lif_mod.lif_fused_from_acc_ref
        args = (acc, bias, beta, thr)
    before = lif_mod.lif_fused.launches
    spk, u = fn(*args, **kw)
    torch.cuda.synchronize()
    assert lif_mod.lif_fused.launches == before + 1  # either form counts
    r_spk, r_u = plain(*args, **kw)
    assert torch.equal(spk, r_spk)
    assert torch.equal(u.isnan(), r_u.isnan())
    assert torch.equal(u.nan_to_num(), r_u.nan_to_num())


@pytest.mark.cuda
def test_lif_kernel_int32_form_wraps_the_bias_add_on_card(cuda_device):
    d = cuda_device
    acc = torch.tensor([[[2**31 - 1, -(2**31), 2**24 + 1, 2**30]]],
                       dtype=torch.int32, device=d).repeat(3, 1, 1)
    bias = torch.tensor([1, -1, 0, 2**15 - 1], dtype=torch.int32, device=d)
    beta, thr = torch.full((4,), 0.9, device=d), torch.ones(4, device=d)
    spk, u = lif_mod.lif_fused_from_acc(acc, bias, beta, thr)
    r_spk, r_u = lif_mod.lif_fused_from_acc_ref(acc, bias, beta, thr)
    assert torch.equal(spk, r_spk) and torch.equal(u, r_u)
    # 2^31 - 1 + 1 wraps to -2^31, a current of -65536: no spike
    assert not spk[:, 0, 0].any() and spk[:, 0, 3].all()


# ------------------------------------------------------------ no fallback
@pytest.mark.cuda
@pytest.mark.parametrize("broken", ["q115_matmul", "spike_matmul", "lif_fused"])
def test_api_raises_when_a_kernel_cannot_build_or_launch_on_card(
        cuda_device, monkeypatch, broken):
    d = cuda_device
    x = torch.ones(4, 8, dtype=torch.int16, device=d)
    spikes = torch.ones(3, 2, 8, device=d)
    w, b = torch.full((8, 4), 0.1, device=d), torch.zeros(4, device=d)
    beta, thr = torch.full((4,), 0.9, device=d), torch.ones(4, device=d)

    def call():
        if broken == "q115_matmul":
            return ops.q115_matmul(x, x.T.contiguous())
        return ops.snn_layer_forward(spikes, w, b, beta, thr)

    real = _build.load

    def no_build(name):
        if name == broken:
            raise RuntimeError(f"nvcc failed for {name}.cu")
        return real(name)

    def failing_launch(name):
        return (lambda *args: 700) if name == broken else real(name)

    monkeypatch.setattr(_build, "load", no_build)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        call()
    monkeypatch.setattr(_build, "load", failing_launch)
    with pytest.raises(RuntimeError, match="launch failed: CUDA error 700"):
        call()


# ------------------------------------------- the serving tick as a graph
def _serving_engine(d, backend="fused", slots=8, **kw):
    """The serving engine at the collision network's full width
    (4096-512-2, Tc = 5), random weights from a seed, the output layer's
    threshold lowered so that it spikes."""
    from repro_torch.configs.collision_snn import CONFIG
    from repro_torch.serving.snn_engine import SNNStreamEngine

    params = snn.init_params(torch.Generator().manual_seed(3), CONFIG, d)
    params[f"layer{CONFIG.num_layers - 1}"]["threshold"].fill_(0.1)
    return SNNStreamEngine(params, CONFIG, num_slots=slots, chunk_steps=5,
                           backend=backend, device=d, **kw)


def _serving_trains(steps, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.random((T, 4096)) < rng.uniform(0.05, 0.4)).astype(np.float32)
            for T in steps]


def _fields(r):
    return (r.prediction, r.steps, r.spike_rate, r.energy_pj,
            r.spike_counts.tolist(), r.events_per_layer.tolist(),
            r.disposition, r.fault)


@pytest.mark.cuda
def test_graph_replay_equals_eager_chunk_on_card(cuda_device):
    from repro_torch.serving.snn_engine import StreamRequest

    eng = _serving_engine(cuda_device)
    trains = _serving_trains([25, 25, 12, 25, 7, 25, 20, 25])
    args = eng.staged_chunk_args(trains)
    states, meta, stats = eng.chunk_for_timing()(*args)
    for x in trains:
        eng.submit(StreamRequest(spikes=x, num_steps=x.shape[0]))
    eng.poll()  # admits all eight, captures, replays chunk 1
    torch.cuda.synchronize()
    assert eng.graphed and eng.graph_captures == eng.graph_replays == 1
    assert eng.graph_launches_per_replay == 1
    assert torch.equal(eng._stats, stats)
    for live, twin in zip(eng._states, states):
        assert torch.equal(live.u, twin.u)
        assert torch.equal(live.refrac, twin.refrac)
    for k in meta:
        assert torch.equal(eng._meta[k], meta[k])
    eng.drain()


@pytest.mark.cuda
def test_ring_growth_recaptures_once_on_card(cuda_device):
    from repro_torch.serving.snn_engine import StreamRequest

    trains = _serving_trains([25, 25, 10, 25, 25, 25, 25], seed=1)
    long = _serving_trains([40], seed=2)[0]
    out = {}
    for backend in ("fused", "fused_ref"):
        eng = _serving_engine(cuda_device, backend=backend)
        for x in trains:
            eng.submit(StreamRequest(spikes=x, num_steps=x.shape[0]))
        results = eng.poll() + eng.poll()  # the graph of the first ring
        eng.submit(StreamRequest(spikes=long, num_steps=40))
        results += eng.drain()  # grows the ring into the free slot
        out[backend] = sorted(results, key=lambda r: r.request_id)
        if backend == "fused":
            assert eng.graph_captures == 2
            assert eng.steady_state_recompiles() == 0
            assert eng.graph_replays == eng.dispatched_ticks
            assert eng._ring["counts"].shape[1] == 45
    assert [_fields(r) for r in out["fused"]] == [
        _fields(r) for r in out["fused_ref"]]
    assert out["fused"][-1].steps == 40


@pytest.mark.cuda
def test_steady_tick_passes_sync_debug_mode_on_card(cuda_device):
    from repro_torch.serving.snn_engine import StreamRequest

    eng = _serving_engine(cuda_device)
    for x in _serving_trains([25] * 8, seed=4):
        eng.submit(StreamRequest(spikes=x))
    eng.poll()
    eng.poll()
    torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        assert eng.poll() == []  # chunk 3 replayed, chunk 2 retired
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocs
    assert len(eng.drain()) == 8
    assert eng.steady_state_recompiles() == 0


@pytest.mark.cuda
def test_failed_capture_raises_on_card(cuda_device, monkeypatch):
    """A chunk that cannot be captured (here: one that reads the card
    from the host) makes the dispatch raise; the engine runs no eager
    chunk in the graph's place."""
    from repro_torch.kernels import snn_chunk as chunk
    from repro_torch.serving.snn_engine import StreamRequest

    eng = _serving_engine(cuda_device, slots=2)
    real = eng._chunk

    def reading_chunk(*args):
        real(*args)
        args[-1].sum().item()  # a host read: illegal while capturing

    monkeypatch.setattr(eng, "_chunk", reading_chunk)
    for x in _serving_trains([25, 25], seed=5):
        eng.submit(StreamRequest(spikes=x))
    before = chunk.snn_chunk.launches
    with pytest.raises(RuntimeError):
        eng.poll()
    torch.cuda.synchronize()
    assert eng.graph_captures == eng.graph_replays == 0
    assert eng.dispatched_ticks == 0 and not eng._inflight
    assert chunk.snn_chunk.launches == before + 1  # the warm-up, on copies
    assert not eng._stats.any()


# ------------------------ faults, preemption and snapshots on the graph
def _buffer_ptrs(eng):
    out = [st.u for st in eng._states] + [st.refrac for st in eng._states]
    out += list(eng._meta.values()) + list(eng._ring.values()) + [eng._stats]
    return [t.data_ptr() for t in out]


@pytest.mark.cuda
def test_injected_nan_reaches_the_graphed_chunk_on_card(cuda_device):
    """The injector writes the NaN into the static buffer in place, so the
    replayed chunk sees it: that slot's request is quarantined, every
    other request equals the fault-free graph run."""
    from repro_torch.faults import Fault, FaultInjector, FaultSchedule
    from repro_torch.serving.snn_engine import StreamRequest

    trains = _serving_trains([25] * 10, seed=6)
    clean = _serving_engine(cuda_device)
    want = clean.run([StreamRequest(spikes=x) for x in trains])
    inj = FaultInjector(FaultSchedule(faults=(
        Fault(tick=2, kind="nan_membrane", slot=3, layer=0),)))
    eng = _serving_engine(cuda_device, injector=inj)
    got = eng.run([StreamRequest(spikes=x) for x in trains])
    assert len(inj.applied) == 1 and inj.applied[0]["slot"] == 3
    bad = inj.applied[0]["rid"]
    assert [r.request_id for r in got if r.disposition != "ok"] == [bad]
    assert got[bad].fault == "nonfinite_state"
    assert [_fields(r) for r in got if r.request_id != bad] == [
        _fields(r) for r in want if r.request_id != bad]
    assert eng.graph_replays == eng.dispatched_ticks
    assert eng.graph_captures == 1 and eng.steady_state_recompiles() == 0


@pytest.mark.cuda
def test_park_and_resume_keep_buffers_and_capture_nothing_on_card(cuda_device):
    """Parking reads a slot's rows back and resuming writes them in place
    through pinned buffers: no chunk buffer moves, nothing is captured
    again, and every result equals the run without preemption."""
    from repro_torch.serving.snn_engine import StreamRequest

    loose = _serving_trains([25] * 8, seed=7)
    tight = _serving_trains([5, 5], seed=8)

    def run(eng, check=None):
        for x in loose:
            eng.submit(StreamRequest(spikes=x, deadline_s=1e4))
        results = eng.poll()
        for x in tight:
            eng.submit(StreamRequest(spikes=x, num_steps=5, deadline_s=5.0))
        while not eng.idle():
            results += eng.poll()
            if check is not None:
                check()
        return sorted(results, key=lambda r: r.request_id)

    want = run(_serving_engine(cuda_device))
    eng = _serving_engine(cuda_device, preempt=True)
    ptrs = []

    def same_buffers():
        ptrs.append(_buffer_ptrs(eng))
        assert ptrs[-1] == ptrs[0]

    got = run(eng, same_buffers)
    snap = eng.metrics_snapshot()
    assert snap["engine.preempt.parked"]["value"] >= 1
    assert (snap["engine.preempt.resumed"]["value"]
            == snap["engine.preempt.parked"]["value"])
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert eng.graph_captures == 1 and eng.steady_state_recompiles() == 0
    assert eng.graph_replays == eng.dispatched_ticks


@pytest.mark.cuda
def test_restore_into_a_captured_engine_recaptures_nothing_on_card(
        cuda_device, tmp_path):
    """Restore copies the snapshot into the buffers the graph holds: an
    engine that has captured keeps its graph, and finishes the windows
    with the uninterrupted run's results."""
    from repro_torch.serving.snn_engine import StreamRequest

    trains = _serving_trains([25, 20, 25, 15, 25, 25, 10, 25, 25, 25],
                             seed=9)
    reqs = [StreamRequest(spikes=x, num_steps=x.shape[0]) for x in trains]
    want = _serving_engine(cuda_device).run(reqs)
    eng1 = _serving_engine(cuda_device)
    for r in reqs:
        eng1.submit(r)
    early = eng1.poll() + eng1.poll()
    path = eng1.snapshot(str(tmp_path / "snap"))
    eng2 = _serving_engine(cuda_device)
    eng2.run(reqs[:1])
    before, ptrs = eng2.graph_captures, _buffer_ptrs(eng2)
    eng2.restore(path)
    assert _buffer_ptrs(eng2) == ptrs
    got = sorted(early + eng2.drain(), key=lambda r: r.request_id)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    assert eng2.graph_captures == before == 1
    assert eng2.steady_state_recompiles() == 0
    assert eng2.graph_replays == eng2.dispatched_ticks


@pytest.mark.cuda
def test_demotion_drops_the_graph_for_the_eager_plain_chunk_on_card(
        cuda_device):
    """Persistent fused failures demote the engine: one warning, the graph
    dropped, and results equal to the plain chunk run eagerly."""
    import warnings

    from repro_torch.faults import (Fault, FaultInjector, FaultSchedule,
                                    RetryPolicy)
    from repro_torch.serving.snn_engine import StreamRequest

    trains = _serving_trains([25, 12, 25, 25, 7, 25, 25, 25, 20], seed=10)
    reqs = [StreamRequest(spikes=x, num_steps=x.shape[0]) for x in trains]
    inj = FaultInjector(FaultSchedule(faults=(Fault(
        tick=0, kind="chunk_exception", times=10**6, only_backend="fused"),)))
    eng = _serving_engine(cuda_device, injector=inj,
                          retry=RetryPolicy(max_retries=1, backoff_s=0.0))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = eng.run(reqs)
    assert sum("demoting backend fused -> torch" in str(w.message)
               for w in caught) == 1
    assert eng.backend == "torch" and not eng.graphed and eng._graph is None
    assert eng.metrics.get("engine.faults.backend_demoted").value == 1
    # captured before the first attempt, never replayed
    assert eng.graph_captures == 1 and eng.graph_replays == 0
    plain = _serving_engine(cuda_device, backend="torch").run(reqs)
    assert [_fields(r) for r in got] == [_fields(r) for r in plain]
    assert all(r.disposition == "ok" for r in got)


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["eager_launch", "graph_launch",
                                   "graph_replay"])
def test_kernel_failure_raises_and_never_demotes_on_card(
        cuda_device, monkeypatch, where):
    """A real failure of the fused chunk on the card (the launcher's
    non-zero return code, on an eager engine or in a graphed engine's
    warm-up, or a failed replay) raises from ``poll()`` at once: no
    retry, no demotion, and the plain chunk never runs in its place."""
    from repro_torch.serving.snn_engine import StreamRequest

    eng = _serving_engine(cuda_device, slots=2,
                          cuda_graph=where != "eager_launch")
    trains = _serving_trains([25, 25, 25, 25], seed=11)
    for x in trains[:2]:
        eng.submit(StreamRequest(spikes=x))
    if where == "graph_replay":
        eng.poll()  # captured and replayed once
        torch.cuda.synchronize()

        class BrokenGraph:
            def replay(self):
                raise RuntimeError("CUDA error: an illegal memory access")

        eng._graph = BrokenGraph()
        for x in trains[2:]:
            eng.submit(StreamRequest(spikes=x))
    else:
        real = _build.load
        monkeypatch.setattr(_build, "load", lambda name: (
            (lambda *args: 700) if name == "snn_chunk" else real(name)))
    ticks, replays = eng.dispatched_ticks, eng.graph_replays
    chunks = []
    real_chunk = eng._chunk

    def counted_chunk(*args):
        chunks.append(eng.backend)
        return real_chunk(*args)

    monkeypatch.setattr(eng, "_chunk", counted_chunk)
    with pytest.raises(RuntimeError, match="CUDA error"):
        eng.poll()
    snap = eng.metrics_snapshot()
    assert snap["engine.faults.chunk_retries"]["value"] == 0
    assert snap["engine.faults.backend_demoted"]["value"] == 0
    assert eng.backend == "fused"
    assert eng.graphed == (where != "eager_launch")
    assert eng.dispatched_ticks == ticks and eng.graph_replays == replays
    # the one failing fused chunk (the eager attempt, or the graph's
    # warm-up before its capture); no chunk after it, plain or fused
    assert chunks == ([] if where == "graph_replay" else ["fused"])
    assert eng.graph_captures == (1 if where == "graph_replay" else 0)



# ------------------------------- the event input path and the baseline
def _dvs_stream(d, n, hw=64, T=25):
    from repro_torch.events import aer

    gen = torch.Generator(device=d).manual_seed(5)
    stream, labels = aer.dvs_collision_batch(gen, n, image_hw=hw,
                                             num_steps=T, capacity=8 * hw * hw)
    return stream, labels


@pytest.mark.cuda
def test_event_forward_aer_kernel_equals_plain_on_card(cuda_device,
                                                       monkeypatch):
    """AER-direct inference at 4096-512-2 on a DVS batch: T x L aer
    launches, equal to the same forward on the kernel's plain version and
    to ``event_forward`` on the densified planes."""
    from repro_torch.configs.collision_snn import CONFIG
    from repro_torch.events import aer

    params = snn.init_params(torch.Generator().manual_seed(3), CONFIG,
                             cuda_device)
    params["layer1"]["threshold"].fill_(0.1)
    stream, _ = _dvs_stream(cuda_device, 6)
    before = aer_mod.aer_spike_matmul_batched.launches
    got = runtime.event_forward_aer(params, stream, CONFIG)
    torch.cuda.synchronize()
    assert aer_mod.aer_spike_matmul_batched.launches - before == (
        CONFIG.num_steps * CONFIG.num_layers)
    planes = aer.input_planes(stream, CONFIG.num_steps, 4096,
                              polarity_mode="signed")
    dense = runtime.event_forward(params, planes, CONFIG, backend="fused")
    monkeypatch.setattr(aer_mod, "aer_spike_matmul_batched",
                        aer_mod.aer_spike_matmul_batched_ref)
    plain = runtime.event_forward_aer(params, stream, CONFIG)
    for x, y in zip(got, plain):
        assert torch.equal(x, y)
    assert torch.equal(got[1], dense[1]) and torch.equal(got[2], dense[2])
    torch.testing.assert_close(got[0], dense[0], atol=1e-5, rtol=1e-5)
    assert got[2][0].sum() > 0 and got[1].sum() > 0


@pytest.mark.cuda
def test_tuned_engine_equals_untuned_and_quarantines_overflow_on_card(
        cuda_device):
    """A plan tuned on two-channel DVS planes (K0 = 8192) serves them as
    the untuned engine does; a train over the tuned C is quarantined."""
    from repro_torch.events import aer, capacity
    from repro_torch.serving.snn_engine import SNNStreamEngine, StreamRequest

    cfg = snn.SNNConfig(layer_sizes=(8192, 512, 2), num_steps=25)
    params = snn.init_params(torch.Generator().manual_seed(3), cfg,
                             cuda_device)
    params["layer1"]["threshold"].fill_(0.1)
    stream, _ = _dvs_stream(cuda_device, 12)
    planes = aer.input_planes(stream, 25, 4096, polarity_mode="two_channel")
    counts = capacity.measure_step_counts(params, cfg, planes,
                                          backend="fused")
    plan = capacity.autotune(params, cfg, planes, counts=counts)
    assert plan.capacities[0] < 8192 and plan.capacities[1] == 512
    trains = [planes[:, i].cpu().numpy() for i in range(12)]
    over = trains[0].copy()
    over[3] = 1.0  # every input spikes at one step: over any C below 8192
    out = {}
    for name, caps in (("tuned", plan.capacities), ("full", None)):
        eng = SNNStreamEngine(params, cfg, num_slots=8, chunk_steps=5,
                              capacities=caps, device=cuda_device)
        out[name] = eng.run([StreamRequest(spikes=x)
                             for x in trains + [over]])
        assert eng.C == (plan.capacities[0] if caps else 8192)
    assert [_fields(r) for r in out["tuned"][:12]] == [
        _fields(r) for r in out["full"][:12]]
    assert out["tuned"][12].fault == "capacity_overflow"
    assert out["full"][12].disposition == "ok"


@pytest.mark.cuda
def test_bcnn_on_card_equals_cpu(cuda_device):
    from repro_torch.core import bcnn
    from repro_torch.data import collision

    torch.backends.cudnn.allow_tf32 = False
    cfg = bcnn.BCNNConfig()
    params = bcnn.init_params(torch.Generator().manual_seed(0), cfg)
    x, y, _, _ = collision.generate(collision.CollisionConfig(
        image_hw=64, num_train=16, num_test=0))
    cpu = bcnn.forward(params, torch.from_numpy(x), cfg)
    card = bcnn.forward({n: {k: v.to(cuda_device) for k, v in lp.items()}
                         for n, lp in params.items()},
                        torch.from_numpy(x).to(cuda_device), cfg)
    torch.testing.assert_close(card.cpu(), cpu, atol=1e-4, rtol=1e-4)


# ------------------------------------------- the graphed training step
@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(32, 4096, 4096, 512, False),  # merged
                                   (2, 300, 60000, 64, False),  # rows
                                   (32, 512, 512, 2, False),  # narrow
                                   (1, 4096, 4096, 512, True)])  # split
def test_aer_kernel_captured_and_replayed_equals_eager_on_card(cuda_device,
                                                               shape):
    """Each variant captured in a CUDA graph and replayed on new inputs
    copied into its static buffers equals an eager launch bit for bit; the
    capture counts once in ``captured`` and nothing in ``launches``."""
    B, E, K, N, int16 = shape
    fn = aer_mod.aer_spike_matmul_batched
    a, v, w = _aer_inputs(B, E, K, N, 0.5, int16, cuda_device, seed=1)
    fn(a, v, w)  # eager first: builds the kernel, raises its smem limit
    torch.cuda.synchronize()
    launches, captured = fn.launches, fn.captured
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(a, v, w)
    assert fn.captured == captured + 1 and fn.launches == launches
    for seed in (2, 3):
        a2, v2, w2 = _aer_inputs(B, E, K, N, 0.5, int16, cuda_device, seed=seed)
        a.copy_(a2)
        v.copy_(v2)
        w.copy_(w2)
        graph.replay()
        want = fn(a2, v2, w2)
        torch.cuda.synchronize()
        assert torch.equal(out, want)
        assert torch.equal(out, aer_mod.aer_spike_matmul_batched_ref(a2, v2, w2))
    assert fn.captured == captured + 1


def _small_trainer(d, jit, **kw):
    from repro_torch.sparse_train import trainer as ev

    tcfg = ev.EventTrainConfig(image_hw=16, hidden=64, num_steps=6,
                               polarity_mode="signed", dropout_rate=0.2)
    return ev.EventTrainer(tcfg, use_kernel=True, energy_lambda=0.05, seed=2,
                           device=d, jit=jit, **kw)


def _train_leaves(state):
    from repro_torch.tree import tree_leaves

    return tree_leaves((state.params, state.opt_state))


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["adam", "schedule"])
def test_graphed_event_trainer_equals_eager_on_card(cuda_device, opt):
    """The default step (one CUDA graph replay) equals the eager step bit
    for bit over 5 steps: params, Adam state and every metric; one
    capture, T x L aer launches in it, a steady replay under
    ``set_sync_debug_mode("error")``."""
    from repro_torch import optim
    from repro_torch.sparse_train import trainer as ev
    from repro_torch.train import loop

    torch.backends.cuda.matmul.allow_tf32 = False

    def make(jit):
        kw = {}
        if opt == "schedule":
            kw["optimizer"] = optim.chain_clip(
                optim.adam(optim.warmup_cosine(1e-3, 2, 10)), 1.0)
        return _small_trainer(cuda_device, jit, **kw)

    runs = {}
    for jit in (True, False):
        tr = make(jit)
        state = tr.init_state(0)
        it = ev.dvs_batches(0, 8, tr.tcfg, device=cuda_device)
        before = aer_mod.aer_spike_matmul_batched.captured
        steps = []
        for i in range(5):
            batch = next(it)
            if jit and i == 3:
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    state, m = tr.step_fn(state, batch)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            else:
                state, m = tr.step_fn(state, batch)
            steps.append(([x.clone() for x in _train_leaves(state)],
                          {k: v.clone() for k, v in m.items()}))
        torch.cuda.synchronize()
        runs[jit] = steps
        if jit:
            assert isinstance(tr.step_fn, loop.StaticStep)
            assert tr.step_fn.captures == 1 and tr.step_fn.replays == 5
            L = tr.snn_cfg.num_layers
            assert (aer_mod.aer_spike_matmul_batched.captured - before
                    == tr.tcfg.num_steps * L)
    for (gl, gm), (el, em) in zip(runs[True], runs[False]):
        assert all(torch.equal(x, y) for x, y in zip(gl, el))
        assert gm.keys() == em.keys()
        assert all(torch.equal(gm[k], em[k]) for k in gm)


@pytest.mark.cuda
def test_restore_into_a_graphed_trainer_resumes_bit_for_bit_on_card(
        cuda_device, tmp_path):
    """A trainer that has captured its step restores a checkpoint into its
    buffers (no buffer moves, no re-capture) and finishes equal to an
    uninterrupted run."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.sparse_train import trainer as ev

    def run(tr, state, n, start):
        it = ev.dvs_batches(0, 8, tr.tcfg, start_step=start, device=cuda_device)
        return tr.run(state, it, n, log_fn=lambda _: None)[0]

    ref = _small_trainer(cuda_device, True)
    s_ref = run(ref, ref.init_state(0), 4, 0)
    first = _small_trainer(cuda_device, True, ckpt_dir=str(tmp_path))
    run(first, first.init_state(0), 2, 0)  # saves step 2
    second = _small_trainer(cuda_device, True)
    s = run(second, second.init_state(5), 1, 7)  # captures over other data
    ptrs = [x.data_ptr() for x in _train_leaves(s)]
    second.ckpt = CheckpointManager(str(tmp_path))  # finds first's saves
    s = second.restore_or_init(9)
    assert s.step == 2 and [x.data_ptr() for x in _train_leaves(s)] == ptrs
    s = run(second, s, 2, s.step)
    torch.cuda.synchronize()
    assert s.step == 4 and second.step_fn.captures == 1
    for x, y in zip(_train_leaves(s), _train_leaves(s_ref)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_engine_ring_growth_is_within_the_capture_contract_on_card(cuda_device):
    from repro_torch.analysis import RecompileDetector
    from repro_torch.serving.snn_engine import StreamRequest

    eng = _serving_engine(cuda_device)
    with RecompileDetector() as det:
        det.track("chunk", eng, allowed=1)  # cold start
        for x in _serving_trains([25, 25, 10], seed=1):
            eng.submit(StreamRequest(spikes=x, num_steps=x.shape[0]))
        eng.poll()
        long = _serving_trains([40], seed=2)[0]
        eng.submit(StreamRequest(spikes=long, num_steps=40))
        eng.drain()  # grows the ring: the allowlisted re-capture
    # the chunk: cold start and the growth; admission: (spikes, 25) and
    # (spikes, 10) on the first ring, (spikes, 40) on the grown one
    assert eng.graph_captures == 2 and eng.admit_captures == 3
    assert det.cache_growth("chunk") == 5 and det.allowed("chunk") == 5
    assert det.backend_compiles == 5 and det.unexpected() == []
    assert eng.steady_state_recompiles() == 0


# ---------------------------------------- admission as CUDA graphs
def _eager_twin(eng, kind, s, data, gen_state):
    """What the eager ``_stage`` writes for this admission, on copies of
    the engine's ring and metadata, drawing an image's uniforms from a
    generator at ``gen_state``."""
    from repro_torch.core import coding

    ring = {k: v.clone() for k, v in eng._ring.items()}
    meta = {k: v.clone() for k, v in eng._meta.items()}
    x = torch.from_numpy(np.asarray(data, np.float32)).to(eng.device)
    u = None
    if kind == "image":
        g = torch.Generator(device=eng.device)
        g.set_state(gen_state)
        u = coding.rate_uniforms(g, (25,) + tuple(x.shape), eng.device)
    eng._stage(ring, meta, eng._slot_ids[s:s + 1], x, uniforms=u)
    return ring, meta


@pytest.mark.cuda
def test_admission_graph_replays_equal_the_eager_stage_on_card(cuda_device):
    """One graph per (kind, T), replayed into other slots with other
    trains and images: ring and metadata equal the eager staging bit for
    bit, every row of every slot."""
    eng = _serving_engine(cuda_device)
    rng = np.random.default_rng(12)
    trains = _serving_trains([25, 25, 10, 25], seed=12)
    steps = [(2, "spikes", trains[0]), (5, "spikes", trains[1]),
             (0, "spikes", trains[2]), (3, "image", rng.random(4096)),
             (7, "image", rng.random(4096)), (6, "spikes", trains[3])]
    for s, kind, data in steps:
        T = data.shape[0] if kind == "spikes" else 25
        torch.cuda.synchronize()
        want_ring, want_meta = _eager_twin(eng, kind, s, data,
                                           eng._gen.get_state())
        eng._admit_graphed(s, kind, T, data)
        torch.cuda.synchronize()
        for k in want_ring:
            assert torch.equal(eng._ring[k], want_ring[k]), (s, kind, k)
        for k in want_meta:
            assert torch.equal(eng._meta[k], want_meta[k]), (s, kind, k)
    assert eng.admit_captures == 3  # (spikes, 25), (spikes, 10), (image, 25)
    assert eng.admit_replays == len(steps)
    assert sorted(eng._admit_graphs) == [("image", 25), ("spikes", 10),
                                         ("spikes", 25)]
    assert eng.steady_state_recompiles() == 0


@pytest.mark.cuda
def test_admission_graphs_capture_once_per_signature_on_card(cuda_device):
    """Served requests capture one admission graph per (kind, T), and the
    graph engine's results equal the eager engine's (images included:
    their uniforms are drawn outside the graph, in the eager order)."""
    from repro_torch.serving.snn_engine import StreamRequest

    rng = np.random.default_rng(13)
    reqs = [StreamRequest(spikes=x, num_steps=x.shape[0])
            for x in _serving_trains([25, 12, 25, 7, 12], seed=13)]
    reqs += [StreamRequest(image=rng.random(4096).astype(np.float32),
                           num_steps=T) for T in (25, 25, 9)]
    eng = _serving_engine(cuda_device)
    got = eng.run(reqs)
    want = _serving_engine(cuda_device, cuda_graph=False).run(reqs)
    assert [_fields(r) for r in got] == [_fields(r) for r in want]
    sigs = {("spikes", 25), ("spikes", 12), ("spikes", 7), ("image", 25),
            ("image", 9)}
    assert eng.admit_captures == len(sigs) and set(eng._admit_graphs) == sigs
    assert eng.admit_replays == len(reqs)
    eng.run(reqs)  # every signature known: replays only
    assert eng.admit_captures == len(sigs)
    assert eng.admit_replays == 2 * len(reqs)
    assert eng.steady_state_recompiles() == 0


@pytest.mark.cuda
def test_ring_growth_drops_the_admission_graphs_on_card(cuda_device):
    from repro_torch.serving.snn_engine import StreamRequest

    eng = _serving_engine(cuda_device, slots=2)
    eng.run([StreamRequest(spikes=x) for x in _serving_trains([25], seed=14)])
    assert eng.admit_captures == 1 and set(eng._admit_graphs) == {
        ("spikes", 25)}
    long = _serving_trains([40], seed=15)[0]
    eng.run([StreamRequest(spikes=long, num_steps=40)])
    assert set(eng._admit_graphs) == {("spikes", 40)}  # the old ones dropped
    got = eng.run([StreamRequest(spikes=x)
                   for x in _serving_trains([25, 25], seed=16)])
    assert eng.admit_captures == 3  # (spikes, 25) once more, on the new ring
    assert eng.steady_state_recompiles() == 0
    want = _serving_engine(cuda_device, slots=2, cuda_graph=False)
    want.run([StreamRequest(spikes=long, num_steps=40)])
    assert [_fields(r) for r in got] == [_fields(r) for r in want.run(
        [StreamRequest(spikes=x) for x in _serving_trains([25, 25], seed=16)])]


@pytest.mark.cuda
def test_steady_admission_passes_sync_debug_mode_on_card(cuda_device):
    """An admission through a captured graph (upload, uniforms, slot
    index, replay) and the tick after it: no implicit synchronisation and
    no device allocation."""
    from repro_torch.serving.snn_engine import StreamRequest

    eng = _serving_engine(cuda_device, slots=2)
    img = np.full(4096, 0.2, np.float32)
    warm = [StreamRequest(spikes=x) for x in _serving_trains([25], seed=17)]
    eng.run(warm + [StreamRequest(image=img)])
    for req in (StreamRequest(spikes=_serving_trains([25], seed=18)[0]),
                StreamRequest(image=img)):
        eng.submit(req)
        torch.cuda.synchronize()
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
        replays = eng.admit_replays
        torch.cuda.set_sync_debug_mode("error")
        try:
            assert eng.poll() == []  # admitted by a replay, chunk 1 replayed
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert eng.admit_replays == replays + 1
        assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocs
        assert len(eng.drain()) == 1
    assert eng.admit_captures == 2 and eng.steady_state_recompiles() == 0


@pytest.mark.cuda
def test_failed_admission_capture_raises_on_card(cuda_device, monkeypatch):
    """A staging that cannot be captured (here: one that reads the card
    from the host) makes the admission raise; nothing stages eagerly in
    its place."""
    from repro_torch.serving.snn_engine import StreamRequest

    eng = _serving_engine(cuda_device, slots=2)
    real = eng._stage

    def reading_stage(ring, meta, slot, x, **kw):
        real(ring, meta, slot, x, **kw)
        meta["total"].sum().item()  # a host read: illegal while capturing

    monkeypatch.setattr(eng, "_stage", reading_stage)
    eng.submit(StreamRequest(spikes=_serving_trains([25], seed=19)[0]))
    with pytest.raises(RuntimeError):
        eng.poll()
    torch.cuda.synchronize()
    assert eng.admit_captures == eng.admit_replays == 0
    assert not eng._admit_graphs
    assert not eng._meta["total"].any() and not eng._ring["counts"].any()
