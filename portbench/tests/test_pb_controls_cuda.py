"""Each cell's control on the card, at the cell's own size: the plain
reference put in the program's place in the precision below the one the
configuration states reads past at least one of the cell's limits, so
the comparison that decides ``correct`` could tell it from the program;
and each planted fault of a training cell does.
Run on the card: ``python3 -m pytest -q -m cuda portbench/tests``."""

import pytest

from portbench import registry

CELLS = ["snn-dvs-closed-s128-t100", "stablelm-train-b2-s4096",
         "snn-train-dvs-b256", "stablelm-serve-b32-p1024"]
SEED = 2**31 + 17


def _cell(cell):
    bench = registry.load_benchmark(registry.ROOT.parent / "BENCHMARK.json")
    if cell not in [w["name"] for w in bench["workloads"]]:
        pytest.skip(f"{cell} is not a cell of BENCHMARK.json")
    w = registry.cell(bench, cell)
    cfg, mix = registry.config(w["config"]), registry.traffic(w["traffic"])
    return cfg, mix, registry.driver(mix["kind"])


def _past(readings: dict, checks: dict) -> dict:
    return {k: readings[k] for k, limit in checks.items()
            if k in readings and readings[k] > limit}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_reads_past_a_limit(card, cell):
    cfg, mix, drv = _cell(cell)
    got = drv.control(cfg, mix, SEED, card)
    got = next((v for k, v in got.items() if k.startswith("control_")), got)
    assert _past(got, mix["checks"]), (got, mix["checks"])


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["stablelm-train-b2-s4096",
                                  "snn-train-dvs-b256"])
def test_each_planted_fault_reads_past_a_limit(card, cell):
    """A training cell's faults read by ``control`` (half the batch, the
    state left unchanged) each read past a limit."""
    cfg, mix, drv = _cell(cell)
    got = drv.control(cfg, mix, SEED, card)
    for fault in ("half_batch", "state_unchanged"):
        assert _past(got[fault], mix["checks"]), (fault, got[fault])
