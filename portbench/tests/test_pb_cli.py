"""The command as a run starts it: without a card, and in a directory
that holds the benchmark alone, it exits with another code than 0 and
prints no result."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

from portbench import registry

CHECKOUT = registry.ROOT.parent
ARGS = ["--workload", "snn-dvs-closed-s128-t100", "--seed", str(2**31 + 3),
        "--seconds", "1", "--trace", "0"]


def _run(cwd: Path):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=300)


def _no_result(proc) -> bool:
    for line in proc.stdout.splitlines():
        try:
            if "correct" in json.loads(line):
                return False
        except (ValueError, TypeError):
            continue
    return True


def test_without_the_card_there_is_no_result(card_absent):
    proc = _run(CHECKOUT)
    assert proc.returncode != 0 and _no_result(proc)
    assert "no card" in proc.stderr


def test_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(registry.ROOT, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0 and _no_result(proc)
