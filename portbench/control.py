"""The control of a cell (and, for a training cell, its planted faults),
on the card at the cell's own size: the readings each compared number's
upper end is set from.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13
    python3 portbench/control.py --workload <cell> --seeds 11 12 13 \
        --fault <name>

prints one JSON line a seed with the readings (``PERF.md`` keeps them
beside each limit).  With ``--fault``, one of the driver's ``FAULTS`` is
planted under the timed path and a whole run of the cell (its own load,
``run_seconds`` long) is judged: the line holds every compared number.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

CHECKOUT = Path(__file__).resolve().parent.parent
for _p in (str(CHECKOUT / "src"), str(CHECKOUT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench import harness, registry  # noqa: E402

harness.set_cache_dirs(CHECKOUT)


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    bench = registry.load_benchmark(CHECKOUT / "BENCHMARK.json")
    w = registry.cell(bench, args.workload)
    cfg = registry.config(w["config"])
    mix = registry.traffic(w["traffic"])
    harness.require_cards(torch, int(w["chips"]))
    drv = registry.driver(mix["kind"])
    if args.fault is not None:
        return planted(bench, args.workload, args.seeds, args.fault,
                       drv.FAULTS[args.fault])
    for seed in args.seeds:
        t0 = time.perf_counter()
        readings = drv.control(cfg, mix, seed, torch.device("cuda", 0))
        print(json.dumps({"workload": args.workload,
                          "seed": seed, "readings": readings,
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


def planted(bench, workload, seeds, name, plant) -> int:
    """Whole runs of ``workload`` with the fault ``plant`` planted, one a
    seed: each compared number beside its limit."""
    from portbench import run as run_mod

    for seed in seeds:
        undo = plant()
        try:
            t0 = time.perf_counter()
            result, checks = run_mod.run_cell(
                bench, workload, seed, bench["run_seconds"], False,
                t_start=t0, log=lambda *a: print(*a, file=sys.stderr))
        finally:
            undo()
        print(json.dumps({"workload": workload, "fault": name, "seed": seed,
                          "correct": result["correct"],
                          "readings": {k: c["value"]
                                       for k, c in checks.items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
