"""Streaming SNN serving on the card: the port's ``--snn`` launcher.

  PYTHONPATH=src python -m repro_torch.launch.serve --snn --requests 16 \
      --batch 8 --image-hw 64 --hidden 512 --num-steps 25 --chunk-steps 5 \
      [--snn-backend fused|torch|auto] [--no-pipeline] [--deadline-ms 50] \
      [--metrics-json m.json] [--trace-out t.json] [--timeseries-out s.jsonl] \
      [--profile-ticks 20 --profile-dir DIR] [--device cuda|cpu]

Requests are rate-coded images of the synthetic collision dataset; the
network's weights are random, made from a seed.  Runs on the card unless
``--device cpu`` is given, and fails rather than fall back to the CPU.
The summary reads the engine's metrics snapshot, its SLO verdict
(``engine.health()``) and its tick-phase breakdown.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.core import snn
from repro_torch.data import collision
from repro_torch.serving.snn_engine import (
    SNNStreamEngine,
    StreamRequest,
    resolve_device,
)


def _serve_snn(args) -> None:
    device = resolve_device(args.device)
    if args.requests <= 0:
        print("snn: nothing to serve (--requests 0)")
        return
    hw = args.image_hw
    input_size = hw * hw
    cfg = snn.SNNConfig(
        layer_sizes=(input_size, args.hidden, 2), num_steps=args.num_steps
    )
    params = snn.init_params(torch.Generator().manual_seed(0), cfg, device)
    engine = SNNStreamEngine(
        params, cfg, num_slots=args.batch, chunk_steps=args.chunk_steps,
        seed=1, backend=args.snn_backend,
        pipeline_depth=0 if args.no_pipeline else 1, device=device,
    )
    data_cfg = collision.CollisionConfig(
        image_hw=hw, num_train=0, num_test=args.requests
    )
    _, _, test_x, _ = collision.generate(data_cfg)
    deadline_s = args.deadline_ms / 1e3 if args.deadline_ms > 0 else None
    reqs = [StreamRequest(image=x.reshape(-1)) for x in test_x]
    if deadline_s is not None:
        reqs = [dataclasses.replace(r, deadline_s=deadline_s) for r in reqs]

    profile = None
    if args.profile_ticks > 0:
        from repro_torch.obs import profile_ticks

        profile = profile_ticks(
            engine, args.profile_dir, num_ticks=args.profile_ticks
        )

    t0 = time.time()
    results = engine.run(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    if profile is not None:
        profile.stop()
    ok = [r for r in results if r.disposition == "ok"]
    n_quar = len(results) - len(ok)
    rate = np.array([r.spike_rate for r in ok]) if ok else np.zeros(1)
    events_total = float(sum(r.events_per_layer.sum() for r in ok))
    disp = f" (ok {len(ok)} | quarantined {n_quar})" if n_quar else ""
    print(
        f"snn[{input_size}->{args.hidden}->2, T={cfg.num_steps}, rate-coded]: "
        f"served {len(results)} reqs in {dt:.2f}s on {args.batch} slots "
        f"(closed-loop){disp}"
    )
    # latency and energy from the metrics snapshot, as the reference's
    # launcher reads them
    snap = engine.metrics_snapshot()
    lat, qw, en = (
        snap["engine.request.latency_s"],
        snap["engine.request.queue_wait_s"],
        snap["engine.request.energy_pj"],
    )
    where = (
        torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    )
    print(
        f"  latency p50/p99: {lat['p50']*1e3:.1f}/{lat['p99']*1e3:.1f} ms"
        f" | queue wait p50: {qw['p50']*1e3:.1f} ms | throughput: "
        f"{events_total/max(dt, 1e-9):.0f} events/s on {where} | "
        f"input rate: {rate.mean():.3f}"
    )
    budget = f"{args.deadline_ms:.0f} ms" if deadline_s is not None else "none"
    misses = int(snap["engine.requests.deadline_missed"]["value"])
    served = int(snap["engine.requests.completed"]["value"])
    print(
        f"  deadline budget {budget}: missed {misses}/{served} "
        f"({misses/max(served, 1):.1%})"
    )
    health = engine.health()
    fired = [
        f"{s['name']}:{s['status']}"
        for s in health["slos"] if s["status"] != "healthy"
    ]
    print(
        f"  health: {health['status'].upper()}"
        + (f" ({', '.join(fired)})" if fired else "")
        + f" — {len(health['slos'])} SLOs, burn-rate rules over "
        f"{health['span_s']:.2f}s of samples"
    )
    diag = health["diagnosis"]
    print(f"  diagnosis: {diag['verdict'].upper()} — {diag['hint']}")
    print(
        f"  measured energy/inference: mean {en['mean']/1e3:.1f} nJ, "
        f"p99 {en['p99']/1e3:.1f} nJ (model estimate from counted events) "
        f"| {engine.dispatched_ticks} ticks on backend {engine.backend}"
        + (f", {engine.graph_replays} graph replays, "
           f"{engine.graph_captures} capture(s), "
           f"{engine.steady_state_recompiles()} steady-state re-captures"
           if engine.graphed else "")
    )
    tb = engine.tick_breakdown()
    print(
        f"  tick breakdown (pipeline_depth={tb['pipeline_depth']}, "
        f"{tb['ticks']} ticks): host prep {tb['host_prep_us']:.0f} us | "
        f"dispatch {tb['dispatch_us']:.0f} us "
        f"(p99 {tb['dispatch_p99_us']:.0f} us) | "
        f"stats fetch {tb['stats_fetch_us']:.0f} us"
    )
    if args.metrics_json:
        engine.metrics.write_json(args.metrics_json)
        print(f"  metrics snapshot -> {args.metrics_json}")
    if args.trace_out:
        engine.export_trace(args.trace_out)
        print(
            f"  chrome trace ({len(engine.trace)} spans) -> "
            f"{args.trace_out} (load in ui.perfetto.dev)"
        )
    if args.timeseries_out:
        engine.timeseries.write_jsonl(args.timeseries_out)
        print(
            f"  time series ({len(engine.timeseries)} samples) -> "
            f"{args.timeseries_out}"
        )
    if profile is not None:
        if profile.error:
            print(f"  torch.profiler capture FAILED: {profile.error}")
        else:
            print(
                f"  torch.profiler capture ({args.profile_ticks} "
                f"steady-state ticks) -> {profile.trace_path}"
            )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--snn", action="store_true",
                    help="serve the event-driven SNN (the only mode ported)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4,
                    help="number of slots served together")
    ap.add_argument("--image-hw", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--num-steps", type=int, default=25)
    ap.add_argument("--chunk-steps", type=int, default=5)
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request latency budget in ms (0 = none)")
    ap.add_argument("--snn-backend", default="auto",
                    choices=["auto", "torch", "fused"],
                    help="chunk hot path: the CUDA snn_chunk kernel, the "
                         "plain PyTorch path, or auto (fused on the card)")
    ap.add_argument("--no-pipeline", action="store_true",
                    help="synchronous ticks (no one-deep stats pipeline)")
    ap.add_argument("--metrics-json", default=None,
                    help="write the engine's metrics-registry snapshot "
                         "(counters/gauges/histograms) to this path")
    ap.add_argument("--trace-out", default=None,
                    help="write per-request + per-tick-phase spans as "
                         "Chrome trace-event JSON (Perfetto-loadable)")
    ap.add_argument("--timeseries-out", default=None,
                    help="write the per-tick time series (counter "
                         "deltas, windowed rates) as JSONL")
    ap.add_argument("--profile-ticks", type=int, default=0,
                    help="capture a torch.profiler trace around N "
                         "steady-state ticks (0 = off)")
    ap.add_argument("--profile-dir",
                    default=os.path.join(tempfile.gettempdir(),
                                         "snn-torch-profile"),
                    help="output directory for --profile-ticks")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; never falls back")
    args = ap.parse_args(argv)
    if not args.snn:
        ap.error("only --snn serving is ported to PyTorch so far")
    _serve_snn(args)


if __name__ == "__main__":
    main()
