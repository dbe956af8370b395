"""The CUDA kernels (``snn_chunk``, ``aer_spike_matmul_batched``) against
their plain PyTorch versions, on the card.  Imports neither JAX nor the reference, so it runs where only the
port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Without a CUDA device every test here skips."""

import numpy as np
import pytest
import torch

from repro_torch.core import neuron, snn
from repro_torch.events import runtime
from repro_torch.kernels import aer_matmul as aer_mod
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
    big = [torch.zeros(64, 60000, device=cuda_device)]
    with pytest.raises(ValueError, match="shared memory"):
        chunk_mod.snn_chunk(big, [torch.zeros(60000, device=cuda_device)] * 1,
                            [torch.zeros(60000, device=cuda_device)],
                            [torch.zeros(60000, device=cuda_device)],
                            [torch.zeros(6, 60000, device=cuda_device)],
                            [torch.zeros(6, 60000, dtype=torch.int32,
                                         device=cuda_device)],
                            (a % 64), v, c, act, layout=layout)


def _aer_inputs(B, E, K, N, rate, int16, dev, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, K, (B, E)).astype(np.int32)
    a[0, :4] = [-1, K, K + 9, 0]  # corrupt addresses are skipped
    v = np.where(rng.random((B, E)) < rate,
                 rng.choice([-1.0, 1.0, 0.5], (B, E)), 0.0).astype(np.float32)
    v[-1] = 0.0  # a stream with no event
    if int16:
        w = rng.integers(-32768, 32768, (K, N)).astype(np.int16)
        v = np.rint(v).astype(np.int32)
    else:
        w = rng.normal(0, 0.05, (K, N)).astype(np.float32)
    return (torch.from_numpy(a).to(dev), torch.from_numpy(v).to(dev),
            torch.from_numpy(w).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("int16", [False, True])
@pytest.mark.parametrize("shape", [(32, 4096, 4096, 512, 0.9),
                                   (32, 4096, 4096, 512, 0.01),
                                   (32, 512, 512, 2, 0.2),
                                   (5, 300, 77, 200, 0.3)])
def test_aer_kernel_matches_plain_version_on_card(cuda_device, int16, shape):
    a, v, w = _aer_inputs(*shape, int16, cuda_device)
    before = aer_mod.aer_spike_matmul_batched.launches
    got = aer_mod.aer_spike_matmul_batched(a, v, w)
    assert aer_mod.aer_spike_matmul_batched.launches == before + 1
    ref = aer_mod.aer_spike_matmul_batched_ref(a, v, w)
    torch.cuda.synchronize()
    assert got.dtype == (torch.int32 if int16 else torch.float32)
    assert torch.equal(got, ref)
    assert not got[-1].any()


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
