"""Tiny copies of the benchmark's cells for the CPU tests: each cell's
configuration and traffic cut to a size the CPU runs in a second, with
the cell's own limits, under a root of their own beside the real
drivers and metric readers."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path
from unittest import mock

from portbench import registry

TINY_CONFIG = {
    "collision-snn": {"layer_sizes": [64, 16, 2]},
    # float32: a tiny model's bfloat16 rounding reads above the limits
    # set at the published widths; the tests here are of the harness
    "stablelm-1.6b": {"num_layers": 2, "d_model": 64, "num_heads": 4,
                      "num_kv_heads": 4, "head_dim": 16, "d_ff": 128,
                      "vocab_size": 512, "dtype": "float32"},
}
TINY_TRAFFIC = {
    "snn_serve": {"clients": 4, "slots": 4, "stagger": 2, "ramp_polls": 4,
                  "window_steps": 10, "pool": 8, "image_hw": 8,
                  "capacity": 640, "trace_capacity": 100000},
    "snn_train": {"batch": 4, "num_steps": 5, "image_hw": 8,
                  "capacity": 512},
    "lm_train": {"batch": 2, "seq": 16},
    "lm_serve": {"batch": 2, "prompt_len": 8, "new_tokens": 4,
                 "cache_len": 12, "judged": 2},
}


def make_root(tmp: Path) -> Path:
    """A root holding tiny configurations and traffic of every cell of
    ``BENCHMARK.json``, and copies of the drivers and readers."""
    root = tmp / "root"
    (root / "configs").mkdir(parents=True)
    (root / "traffic").mkdir()
    for sub in ("drivers", "metrics"):
        shutil.copytree(registry.ROOT / sub, root / sub)
    bench = registry.load_benchmark(registry.ROOT.parent / "BENCHMARK.json")
    for w in bench["workloads"]:
        cfg = registry.config(w["config"])
        cfg.update(TINY_CONFIG[w["config"]])
        (root / "configs" / f"{w['config']}.json").write_text(json.dumps(cfg))
        mix = registry.traffic(w["traffic"])
        mix.update(TINY_TRAFFIC[mix["kind"]])
        (root / "traffic" / f"{w['traffic']}.json").write_text(
            json.dumps(mix))
    return root


def run(root: Path, workload: str, *, seconds: float = 0.5, trace=False,
        seed: int = 2**31 + 7, bench=None):
    """One run of a tiny cell on the CPU, past the harness's look for a
    card and its import guard (a test process may hold JAX, loaded by
    the parity tests beside these): (result, checks)."""
    from portbench import harness
    from portbench import run as run_mod

    if bench is None:
        bench = registry.load_benchmark(registry.ROOT.parent /
                                        "BENCHMARK.json")
    with mock.patch.object(harness, "forbidden_loaded", lambda: []):
        return run_mod.run_cell(bench, workload, seed, seconds, trace,
                                root=root, device="cpu", look_for_card=False,
                                t_start=time.perf_counter(),
                                log=lambda *a: None)
