"""The port's SNN examples (``repro_torch.examples``) run end to end at
tiny sizes on the CPU, each in a process of its own that must not load
JAX or the reference package, and print their report lines."""

import importlib
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
TRAIN = ["--image-hw", "8", "--hidden", "16", "--steps", "5", "--epochs",
         "1", "--batch", "16", "--num-train", "32", "--num-test", "16"]
EXAMPLES = {
    "quickstart": (TRAIN + ["--hw-samples", "8"], [
        "dataset: (32, 8, 8) train", "rate coding: pixel intensity",
        "epoch 0: loss=", "test accuracy (float model):",
        "test accuracy (Q1.15 hardware path, plain versions):"]),
    "collision_avoidance": (
        ["--image-hw", "8", "--hidden", "16", "--num-steps", "5", "--steps",
         "3", "--batch", "16", "--num-train", "32", "--num-test", "16",
         "--refractory", "2", "--q115"],
        ["step     0 loss=", "RESULT neuron=lif image=8px refractory=2 "
         "q115=True: train_acc=", "paper Table 1"]),
    "event_stream_serving": (
        ["--image-hw", "8", "--hidden", "16", "--steps", "10", "--requests",
         "6", "--slots", "2"],
        ["served 6 requests (3 rate-coded, 3 DVS) on 2 slots, backend torch",
         "engine.request.energy_pj: p50=", "  rate: mean input rate",
         "  dvs : mean input rate", "SLO verdict:"]),
    "refractory_ablation": (TRAIN + ["--refractory", "0", "5"], [
        "refractory | test_acc | hidden_rate | energy/inf (nJ)",
        "         0 |", "         5 |", "(1.00x)"]),
    "coding_ablation": (TRAIN, [
        "encoder              | test_acc", "rate (paper)",
        "rate_deterministic", "ttfs"]),
    "serve_quantized_lm": (
        ["--requests", "3", "--new-tokens", "4", "--batch", "2", "--q115"],
        ["arch=stablelm-1.6b (reduced) params=", "quant=q115",
         "served 3 requests, 12 new tokens in", "tok/s (CPU)",
         "  req0: prompt_len=", "Q1.15 mode: weights snapped"]),
}
RUN = """
import sys
from repro_torch.examples import {name}
{name}.main({argv!r})
bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))
assert not bad, bad
"""


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_tiny_on_cpu_without_jax(name):
    argv, lines = EXAMPLES[name]
    out = subprocess.run(
        [sys.executable, "-c", RUN.format(name=name,
                                          argv=argv + ["--device", "cpu"])],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "OMP_NUM_THREADS": "2"},
    )
    assert out.returncode == 0, out.stderr
    for line in lines:
        assert line in out.stdout, (line, out.stdout)


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_needs_the_card_unless_told_cpu(monkeypatch, name):
    """Without ``--device cpu`` an example runs on the card; with none it
    raises rather than fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(EXAMPLES[name][0])
