"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for.  Set-up builds the system under test from the seed and warms every
shape the cell uses; the window then runs the cell's traffic for
``--seconds`` seconds (``--trace 1``: under ``torch.profiler``, reporting
the per-layer metrics in place of the end-to-end ones); after it the
program's state is freed and the plain reference judges what the window
produced.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and ``checks`` last); each number compared
is also printed beside its limit as the last lines of standard error.
The exit code is not 0, and no result is printed, without the cards, when
the JAX stack or the JAX package was loaded by the time the result would
be printed (the guard runs after the reference and the metric readers),
or when the program is not beside the benchmark.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
for _p in (str(CHECKOUT / "src"), str(CHECKOUT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from portbench import harness, registry  # noqa: E402

harness.set_cache_dirs(CHECKOUT)


def run_cell(bench, workload: str, seed: int, seconds: float, trace: bool,
             *, root: Path = registry.ROOT, device=None,
             look_for_card: bool = True, t_start: float = T_START,
             log=print):
    """One run of ``workload``: returns (result, checks).  Tests pass
    ``look_for_card=False`` and a CPU ``device`` to drive the rest of a
    run at a tiny size."""
    w = registry.cell(bench, workload)
    cfg = registry.config(w["config"], root)
    mix = registry.traffic(w["traffic"], root)
    if look_for_card:
        harness.host_threads(mix.get("host_threads"))
    import torch

    if look_for_card:
        harness.require_cards(torch, int(w["chips"]))
        device = torch.device("cuda", 0)
        facts = harness.card_facts()
        log(f"card: {torch.cuda.get_device_name(0)} | " + " | ".join(
            f"{k} {v}" for k, v in facts.items()) + f" | torch "
            f"{torch.__version__} cuda {torch.version.cuda}")
    device = torch.device(device)
    spans = harness.Spans(torch, traced=trace)
    drv = registry.driver(mix["kind"], root).Cell(
        cfg, mix, seed, device, spans, log=log)
    drv.setup()
    setup_s = time.perf_counter() - t_start - drv.check_setup_s
    log(f"setup: {setup_s:.3f} s (the reference's steps in set-up, "
        f"{drv.check_setup_s:.3f} s, left out)")
    on_card = device.type == "cuda"
    captures0 = drv.captures()
    with harness.traced(torch, trace) as prof:
        with spans.span("window"):
            e2e = drv.window(float(seconds))
        if on_card:
            torch.cuda.synchronize(device)
    captures_in_window = drv.captures() - captures0
    log(f"window: {drv.window_s:.6f} s | captures inside it "
        f"{captures_in_window} (expected 0)")
    peak = (max(torch.cuda.max_memory_allocated(d)
                for d in range(int(w["chips"]))) if on_card else 0)
    log(f"memory: peak allocated {peak} B" + (
        f" of {torch.cuda.get_device_properties(0).total_memory} B"
        if on_card else "") + drv.memory_note())
    reduced = None
    if prof is not None:
        reduced = harness.reduce_trace(prof.profiler.kineto_results.events())
    ctx = dict(drv.layer_ctx())
    ctx.update(trace=reduced, window_s=drv.window_s)
    drv.release()
    t_judge = time.perf_counter()
    checks = drv.judge()
    log(f"judge: {time.perf_counter() - t_judge:.3f} s (after the window, "
        f"not in setup_s)")
    metrics = {}
    if trace:
        for m in registry.per_layer_of(bench, workload):
            v = registry.metric_reader(m["name"], root).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e["setup_s"] = setup_s
        for m in registry.end_to_end_of(bench, workload):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": int(w["chips"]) if on_card else 1,
           "memory_peak_bytes": int(peak)}
    result = {"correct": all(c["ok"] for c in checks.values()),
              "attempted": drv.attempted, "failed": drv.failed,
              "metrics": metrics, "device": dev}
    if reduced is not None:
        dev["busy_s"] = reduced["busy_s"]
        dev["window_s"] = reduced["window_s"]
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in reduced["device_ops"]],
            "idle_gaps": [[n, s] for n, s in reduced["idle_gaps"]]}
    # after the reference and every metric reader: what they loaded counts
    harness.refuse_forbidden()
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = registry.load_benchmark(CHECKOUT / "BENCHMARK.json")
    result, checks = run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace))
    harness.refuse_forbidden()
    harness.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
