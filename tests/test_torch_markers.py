"""Phase markers (``kernels.markers``): where the LM serving engine and the
static training step put them, that they launch nothing off the card,
and, on the card (``-m cuda``), that a profiled graphed run shows one
marker pair for each prefill, decode step and training step the program
counted.  Imports neither JAX nor the reference, so the card test runs
where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_markers.py
"""

import re

import numpy as np
import pytest
import torch

import repro_torch.configs as configs
from repro_torch.kernels import _build, markers
from repro_torch.launch.serve import lm_requests
from repro_torch.models.model import Model
from repro_torch.optim import adam, chain_clip
from repro_torch.serving.engine import ServeEngine
from repro_torch.train.loop import Trainer


class _Linear:
    """A least-squares model: the smallest thing a ``Trainer`` trains."""

    def init(self, seed):
        g = torch.Generator().manual_seed(seed)
        return {"w": torch.randn(8, 2, generator=g),
                "b": torch.zeros(2)}

    def loss(self, params, batch):
        err = batch["x"] @ params["w"] + params["b"] - batch["y"]
        loss = (err * err).mean()
        return loss, {"loss": loss.detach()}


def _batches(device, seed=0):
    g = torch.Generator().manual_seed(seed)
    while True:
        yield {"x": torch.randn(4, 8, generator=g).to(device),
               "y": torch.randn(4, 2, generator=g).to(device)}


def _recording(monkeypatch):
    seen = []
    monkeypatch.setattr(markers, "mark",
                        lambda phase, device: seen.append(phase))
    return seen


def test_phases_follow_the_sources_table():
    """The launcher's phase index is a phase's place in ``PHASES`` and in
    the source's ``PHASE_MARKERS``, each a kernel of its own name."""
    src = (_build.CSRC / "phase_marker.cu").read_text()
    table = src[src.index("PHASE_MARKERS[]"):]
    assert re.findall(r"phase_marker_(\w+?),", table[:table.index("};")]) \
        == list(markers.PHASES)
    for phase in markers.PHASES:
        assert f"PHASE_MARKER({phase})" in src
    assert _build.SIGNATURES["phase_marker"][0] == "phase_marker_launch"


def test_a_marker_off_the_card_loads_and_launches_nothing(monkeypatch):
    def no_build(name):
        raise AssertionError(f"built {name} off the card")

    monkeypatch.setattr(_build, "load", no_build)
    for phase in markers.PHASES:
        markers.mark(phase, torch.device("cpu"))
        markers.mark(phase, torch.device("meta"))
    with pytest.raises(KeyError):
        markers.mark("no_such_phase", torch.device("cpu"))


@pytest.mark.parametrize("cuda_graph", [True, False])
def test_each_prefill_and_decode_step_is_bracketed(monkeypatch, cuda_graph):
    """Three requests at batch 2, 5 new tokens: two prefills and 2 x 4
    decode steps, each between its begin and end marker, whether the
    engine's bodies run over static buffers or eagerly."""
    cfg = configs.get("stablelm-1.6b").reduced()
    model = Model(cfg)
    eng = ServeEngine(model, model.init(0, "cpu"), 2, 32,
                      cuda_graph=cuda_graph)
    seen = _recording(monkeypatch)
    eng.generate(lm_requests(cfg, 3, 5, seed=1))
    batch = (["prefill_begin", "prefill_end"]
             + ["decode_begin", "decode_end"] * 4)
    assert seen == batch * 2


def test_each_static_step_brackets_its_update(monkeypatch):
    """The update phase's two markers come once a step, after the
    gradients, in the step's set-up run and in every later step."""
    seen = _recording(monkeypatch)
    trainer = Trainer(_Linear(), chain_clip(adam(1e-2), 1.0))
    state = trainer.init_state(0)
    batches = _batches("cpu")
    for _ in range(3):
        state, _ = trainer.step_fn(state, next(batches))
    assert seen == ["update_begin", "update_end"] * 3


def _marker_pairs(prof):
    """Begin and end markers in the profiler's trace, by phase."""
    names = [ev.name() for ev in prof.profiler.kineto_results.events()
             if ev.name().startswith("phase_marker_")]
    return {p: names.count("phase_marker_" + p) for p in markers.PHASES}


@pytest.mark.cuda
def test_profiled_graph_replays_show_one_marker_pair_a_phase_on_card():
    """A warm graphed ``generate`` (replays only) and graphed training
    steps under ``torch.profiler``: one begin and one end marker kernel
    for every prefill, decode step and step the program counted, and the
    served tokens equal an engine's without graphs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the markers launch only on the "
                    "card")
    dev = torch.device("cuda")
    cfg = configs.get("stablelm-1.6b").reduced()
    model = Model(cfg)
    params = model.init(0, dev)
    eng = ServeEngine(model, params, 2, 32)
    reqs = lm_requests(cfg, 4, 6, seed=3)
    eng.generate(reqs)  # each signature's first run, then its capture
    trainer = Trainer(_Linear(), chain_clip(adam(1e-2), 1.0))
    params_t = {k: v.to(dev) for k, v in trainer.model.init(0).items()}
    state = trainer.init_state(0)._replace(
        params=params_t, opt_state=trainer.optimizer.init(params_t))
    batches = _batches(dev)
    state, _ = trainer.step_fn(state, next(batches))  # the capture
    prefills, decodes = eng._prefill.replays, eng._decode.replays
    steps = trainer.step_fn.replays
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        got = eng.generate(reqs)
        for _ in range(3):
            state, _ = trainer.step_fn(state, next(batches))
        torch.cuda.synchronize()
    pairs = _marker_pairs(prof)
    prefills = eng._prefill.replays - prefills
    decodes = eng._decode.replays - decodes
    steps = trainer.step_fn.replays - steps
    assert (prefills, decodes, steps) == (2, 2 * 5, 3)
    # stablelm has no MoE layer or MLA core: their markers are silent
    assert pairs == {"prefill_begin": prefills, "prefill_end": prefills,
                     "decode_begin": decodes, "decode_end": decodes,
                     "update_begin": steps, "update_end": steps,
                     "moe_begin": 0, "moe_end": 0, "mla_begin": 0,
                     "mla_end": 0}
    eager = ServeEngine(model, params, 2, 32, cuda_graph=False)
    for g, w in zip(got, eager.generate(reqs)):
        np.testing.assert_array_equal(g, w)
