"""DeepSeek-V2's layers on the card (``-m cuda``): the dropless expert
layer's grouped products against the plain loop, and a profiled graphed
``generate`` showing one ``moe`` marker pair per expert layer and one
``mla`` pair per layer in every prefill and decode step, with the
routed-pairs counter summed inside the graphs equal to the eager
engine's.  Imports neither JAX nor the reference package, so it runs
where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_deepseek_v2_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.models import moe
from repro_torch.models.config import DeepSeekV2Config
from repro_torch.models.model import Model
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serving.engine import Request, ServeEngine

TINY = DeepSeekV2Config(
    name="deepseek-v2-tiny", family="moe", num_layers=3, d_model=128,
    num_heads=4, num_kv_heads=4, head_dim=24, d_ff=64, vocab_size=512,
    norm_kind="rmsnorm", norm_eps=1e-6, mla=True, q_lora_rank=None,
    kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
    v_head_dim=16, num_experts=4, num_experts_per_tok=3,
    router_softmax_order="softmax_then_topk_raw", router_experts=8,
    expert_offset=4, num_shared_experts=1, first_k_dense=1, dense_d_ff=256,
    yarn_factor=40.0, yarn_mscale=0.707, yarn_mscale_all_dim=0.707,
    dtype="bfloat16")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the grouped products and the "
                    "markers run only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_grouped_products_equal_the_plain_loop_on_card(dev):
    cfg = dataclasses.replace(TINY, num_shared_experts=0)
    g = torch.Generator(device=dev).manual_seed(0)
    f = {"router": torch.randn(128, 8, device=dev, generator=g) * 0.1,
         "w_gate": torch.randn(4, 128, 64, device=dev, generator=g) * 0.1,
         "w_up": torch.randn(4, 128, 64, device=dev, generator=g) * 0.1,
         "w_down": torch.randn(4, 64, 128, device=dev, generator=g) * 0.1}
    x = torch.randn(2, 40, 128, device=dev, generator=g).to(torch.bfloat16)
    got = moe.dropless_forward(f, x, cfg)[0].float().reshape(80, -1)
    xt = x.reshape(80, -1)
    w, idx = moe.router_weights(xt.float() @ f["router"], cfg)
    want = torch.zeros(80, 128, device=dev)
    for e in range(4):
        b = {k: f[k][e].to(torch.bfloat16) for k in ("w_gate", "w_up",
                                                      "w_down")}
        h = torch.nn.functional.silu(xt @ b["w_gate"]) * (xt @ b["w_up"])
        we = (w * (idx == 4 + e)).sum(-1, keepdim=True)
        want += we * (h @ b["w_down"]).float()
    torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


def _pairs(prof):
    names = [ev.name() for ev in prof.profiler.kineto_results.events()
             if ev.name().startswith("phase_marker_")]
    return {p: names.count("phase_marker_" + p)
            for p in ("prefill_begin", "decode_begin", "moe_begin",
                      "moe_end", "mla_begin", "mla_end")}


@pytest.mark.cuda
def test_markers_and_the_expert_counter_in_graph_replays_on_card(dev):
    model = Model(TINY)
    params = model.init(0, dev)
    rng = np.random.default_rng(3)
    reqs = [Request(prompt=rng.integers(0, 512, 12).astype(np.int32),
                    max_new_tokens=6) for _ in range(4)]
    eng = ServeEngine(model, params, 2, 32)
    eng.generate(reqs)  # each signature's first run, then its capture
    moe.publish_expert_load(MetricsRegistry(), dev)
    prefills, decodes = eng._prefill.replays, eng._decode.replays
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = eng.generate(reqs)
        torch.cuda.synchronize()
    graphed = moe.publish_expert_load(MetricsRegistry(), dev)
    prefills = eng._prefill.replays - prefills
    decodes = eng._decode.replays - decodes
    assert (prefills, decodes) == (2, 2 * 5)
    calls = prefills + decodes
    assert _pairs(prof) == {"prefill_begin": prefills,
                            "decode_begin": decodes,
                            "moe_begin": 2 * calls, "moe_end": 2 * calls,
                            "mla_begin": 3 * calls, "mla_end": 3 * calls}
    eager = ServeEngine(model, params, 2, 32, cuda_graph=False)
    want = eager.generate(reqs)
    counted = moe.publish_expert_load(MetricsRegistry(), dev)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert graphed == counted and sum(graphed) > 0
