"""Finds what a cell is made of by the names in ``BENCHMARK.json``.

A configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json`` (its ``kind`` names the driver,
``drivers/<kind>.py``), a per-layer metric ``metrics/<name>.py`` with a
``read(ctx)`` function.  Adding a cell, a mix, a configuration or a
metric adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parent


def load_benchmark(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: Dict, name: str) -> Dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in bench['workloads']]}")


def config(name: str, root: Path = ROOT) -> Dict:
    with open(root / "configs" / f"{name}.json") as f:
        return json.load(f)


def traffic(name: str, root: Path = ROOT) -> Dict:
    with open(root / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _module(path: Path, name: str) -> ModuleType:
    if not path.is_file():
        raise FileNotFoundError(f"{path} does not exist")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str, root: Path = ROOT) -> ModuleType:
    return _module(root / "drivers" / f"{kind}.py", f"portbench_driver_{kind}")


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    mod = _module(root / "metrics" / f"{name}.py",
                  "portbench_metric_" + name.replace(".", "_"))
    if not callable(getattr(mod, "read", None)):
        raise AttributeError(f"metrics/{name}.py has no read(ctx)")
    return mod


def end_to_end_of(bench: Dict, workload: str) -> List[Dict]:
    """The end-to-end metrics a cell reports: those without a
    ``workloads`` key, and those that list it."""
    return [m for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])]


def per_layer_of(bench: Dict, workload: str) -> List[Dict]:
    """The per-layer metrics a traced run of the cell reports: those that
    list it, and those without a ``workloads`` key whose end-to-end metric
    the cell reports."""
    reported = {m["name"] for m in end_to_end_of(bench, workload)}
    out = []
    for m in bench["per_layer"]:
        listed: Optional[List[str]] = m.get("workloads")
        if (workload in listed) if listed is not None else (
                m["moves"] in reported):
            out.append(m)
    return out
