"""The registry finds a cell's parts by name, and BENCHMARK.json keeps to
the shape its readers take: the keys, names, units, bounds and the
metrics each cell reports."""

import json
import re
import sys
import time

import pytest

import pb_tiny
from portbench import registry
from portbench import run as run_mod

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")

DUMMY_DRIVER = '''
from portbench.cellbase import CellBase


class Cell(CellBase):
    def setup(self):
        self.n = int(self.mix["work"])

    def window(self, seconds):
        self.window_s = 1.0
        self.attempted = self.n
        return {"dummy_rate": float(self.n) * self.cfg["scale"]}

    def layer_ctx(self):
        return {"dummy": self.n}

    def release(self):
        pass

    def judge(self):
        return self.checks({"gap": 0.0})
'''


def test_a_cell_added_as_files_alone_runs(tmp_path):
    root = tmp_path / "root"
    for sub in ("configs", "traffic", "drivers", "metrics"):
        (root / sub).mkdir(parents=True)
    (root / "configs" / "toy.json").write_text(json.dumps({"scale": 2.0}))
    (root / "traffic" / "toy-mix.json").write_text(
        json.dumps({"kind": "toy_kind", "work": 3, "checks": {"gap": 0}}))
    (root / "drivers" / "toy_kind.py").write_text(DUMMY_DRIVER)
    (root / "metrics" / "toy.count.py").write_text(
        "def read(ctx):\n    return ctx.get('dummy')\n")
    bench = {
        "workloads": [{"name": "toy-cell", "config": "toy",
                       "traffic": "toy-mix", "chips": 1, "why": "x"}],
        "end_to_end": [
            {"name": "dummy_rate", "unit": "1/s", "better": "higher",
             "bound": 0.1, "source": "host_clock", "workloads": ["toy-cell"]},
            {"name": "setup_s", "unit": "s", "better": "lower",
             "bound": 0.25, "source": "host_clock"}],
        "per_layer": [{"name": "toy.count", "unit": "n", "better": "higher",
                       "source": "program_counter", "layer": "toy",
                       "moves": "dummy_rate"}],
    }
    for trace in (False, True):
        res, checks = pb_tiny.run(root, "toy-cell", seconds=0.1,
                                  trace=trace, seed=5, bench=bench)
        assert res["correct"] and checks["gap"]["ok"]
        if trace:
            assert res["metrics"] == {"toy.count": {"value": 3, "unit": "n"}}
        else:
            assert res["metrics"]["dummy_rate"]["value"] == 6.0
            assert set(res["metrics"]) == {"dummy_rate", "setup_s"}


def test_a_forbidden_module_in_the_process_stops_the_run(tmp_path,
                                                         monkeypatch):
    """The guard before the result, unpatched: a module of the JAX
    package in the process ends the run with no result."""
    root = pb_tiny.make_root(tmp_path)
    monkeypatch.setitem(sys.modules, "repro.planted", object())
    bench = registry.load_benchmark(registry.ROOT.parent / "BENCHMARK.json")
    with pytest.raises(SystemExit, match="repro"):
        run_mod.run_cell(bench, "snn-dvs-closed-s128-t100", 3, 0.2, False,
                         root=root, device="cpu", look_for_card=False,
                         t_start=time.perf_counter(), log=lambda *a: None)


PLANT = ("import sys, types\n"
         "sys.modules.setdefault('jax.pb_planted', "
         "types.ModuleType('jax.pb_planted'))\n")


@pytest.mark.parametrize("where", ["metric_reader", "reference"])
def test_what_a_reader_or_the_reference_loads_stops_the_run(
        tmp_path, monkeypatch, where):
    """A metric file or a driver's judging that loads the JAX stack after
    the window has closed still ends the run with no result: the guard
    runs last, before the result.  Only what the run loads counts here (a
    test process may hold JAX already)."""
    from portbench import harness

    root = tmp_path / "root"
    for sub in ("configs", "traffic", "drivers", "metrics"):
        (root / sub).mkdir(parents=True)
    (root / "configs" / "toy.json").write_text(json.dumps({"scale": 1.0}))
    (root / "traffic" / "toy-mix.json").write_text(
        json.dumps({"kind": "toy_kind", "work": 1, "checks": {"gap": 0}}))
    driver = DUMMY_DRIVER
    if where == "reference":
        driver = driver.replace("    def judge(self):\n",
                                "    def judge(self):\n" + "".join(
                                    "        " + ln + "\n"
                                    for ln in PLANT.splitlines()))
    (root / "drivers" / "toy_kind.py").write_text(driver)
    reader = "def read(ctx):\n    return 1.0\n"
    if where == "metric_reader":
        reader = PLANT + reader
    (root / "metrics" / "toy.count.py").write_text(reader)
    bench = {
        "workloads": [{"name": "toy-cell", "config": "toy",
                       "traffic": "toy-mix", "chips": 1, "why": "x"}],
        "end_to_end": [{"name": "dummy_rate", "unit": "1/s",
                        "better": "higher", "bound": 0.1,
                        "source": "host_clock"},
                       {"name": "setup_s", "unit": "s", "better": "lower",
                        "bound": 0.25, "source": "host_clock"}],
        "per_layer": [{"name": "toy.count", "unit": "n", "better": "higher",
                       "source": "program_counter", "layer": "toy",
                       "moves": "dummy_rate"}],
    }
    before = set(sys.modules)
    real = harness.forbidden_loaded
    monkeypatch.setattr(harness, "forbidden_loaded", lambda: real(
        [m for m in list(sys.modules) if m not in before]))
    try:
        with pytest.raises(SystemExit, match="jax"):
            run_mod.run_cell(bench, "toy-cell", 3, 0.1, True, root=root,
                             device="cpu", look_for_card=False,
                             t_start=time.perf_counter(),
                             log=lambda *a: None)
    finally:
        sys.modules.pop("jax.pb_planted", None)


def test_a_missing_part_is_named():
    with pytest.raises(FileNotFoundError):
        registry.metric_reader("no.such.metric")
    with pytest.raises(KeyError):
        registry.cell({"workloads": []}, "nothing")


def test_metrics_of_a_cell():
    bench = {
        "end_to_end": [{"name": "a", "workloads": ["c1"]}, {"name": "setup_s"}],
        "per_layer": [{"name": "x", "moves": "a"},
                      {"name": "y", "moves": "a", "workloads": ["c2"]},
                      {"name": "z", "moves": "setup_s"}],
    }
    assert [m["name"] for m in registry.end_to_end_of(bench, "c1")] == [
        "a", "setup_s"]
    assert [m["name"] for m in registry.end_to_end_of(bench, "c2")] == [
        "setup_s"]
    assert [m["name"] for m in registry.per_layer_of(bench, "c1")] == [
        "x", "z"]
    assert [m["name"] for m in registry.per_layer_of(bench, "c2")] == [
        "y", "z"]


def test_benchmark_json_keeps_its_shape():
    path = registry.ROOT.parent / "BENCHMARK.json"
    assert path.stat().st_size <= 64 * 1024
    b = json.loads(path.read_text())
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"] and b["command"][1].startswith(
        "portbench/")
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"]: c for c in b["configs"]}
    files = [c["file"] for c in b["configs"]]
    assert len(files) == len(set(files))
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
        assert (registry.ROOT.parent / c["file"]).is_file()
        assert c["file"] == f"portbench/configs/{c['name']}.json"
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = {w["name"]: w for w in b["workloads"]}
    assert len(cells) == len(b["workloads"])
    pairs = {(w["config"], w["traffic"]) for w in b["workloads"]}
    assert len(pairs) == len(cells)
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] == 1
        assert len(w["why"]) <= 200
        mix = registry.traffic(w["traffic"])
        assert (registry.ROOT / "drivers" / f"{mix['kind']}.py").is_file()
        reported = [m for m in registry.end_to_end_of(b, w["name"])]
        assert len(reported) >= 2 and any(m["name"] == "setup_s"
                                          for m in reported)
        assert registry.per_layer_of(b, w["name"])
    used = {w["config"] for w in b["workloads"]}
    assert used == set(configs)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert all(c in cells for c in m.get("workloads", []))
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for c in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in
                                  registry.end_to_end_of(b, c)}
        assert callable(registry.metric_reader(m["name"]).read)
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline") and m["unit"] == "%"
