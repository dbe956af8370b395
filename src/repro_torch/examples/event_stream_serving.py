"""Demo: streaming event-driven SNN serving with async admission.

Builds a small collision-avoidance SNN, then serves a mixed workload
through the streaming engine's ``submit()/poll()`` scheduler:

  1. rate-coded camera frames (procedural collision scenes), and
  2. synthetic DVS event-camera recordings (AER brightness-change events),
     submitted mid-flight, while the rate-coded requests' chunks are
     still integrating, with a latency deadline and a higher priority, so
     they overtake the queued tail of the first batch.

More requests than slots, so continuous batching, the persistent per-slot
membrane state and the deadline and queue-wait accounting all run.  The
report comes from the engine's observability layer: the metrics-registry
snapshot (latency, queue-wait and energy percentiles, request counters),
windowed rates from the time series, and the burn-rate SLO verdict
(``engine.health()``).  One line is the paper's claim in miniature: the
mean modelled energy of each traffic class at one network shape.

  PYTHONPATH=src python -m repro_torch.examples.event_stream_serving \\
      [--steps 25] [--seed 0] [--requests 12] [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core import snn
from repro_torch.data import collision
from repro_torch.events import aer
from repro_torch.examples import _common
from repro_torch.serving.snn_engine import (
    SNNStreamEngine,
    StreamRequest,
    resolve_device,
)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=25,
                    help="SNN coding window (time steps)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for weights, data and encodings")
    ap.add_argument("--requests", type=int, default=12,
                    help="total requests (half rate-coded, half DVS)")
    ap.add_argument("--image-hw", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--slots", type=int, default=4)
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    hw = args.image_hw
    n_rate = args.requests // 2
    n_dvs = args.requests - n_rate

    cfg = snn.SNNConfig(layer_sizes=(hw * hw, args.hidden, 2),
                        num_steps=args.steps)
    params = snn.init_params(torch.Generator().manual_seed(args.seed), cfg,
                             device)
    engine = SNNStreamEngine(params, cfg, num_slots=args.slots,
                             chunk_steps=5, seed=args.seed, device=device)

    rate_reqs = []
    if n_rate:  # rate-coded procedural camera frames
        _, _, frames, _ = collision.generate(collision.CollisionConfig(
            image_hw=hw, num_train=0, num_test=n_rate, seed=args.seed))
        rate_reqs = [StreamRequest(image=f.reshape(-1)) for f in frames]

    dvs_reqs = []
    if n_dvs:
        # synthetic DVS recordings densified to the engine's input plane
        # (ON events only: the input layer is hw*hw wide; the serve
        # launcher's --dvs --polarity has the polarity-aware layers)
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        stream, _ = aer.dvs_collision_batch(
            gen, n_dvs, image_hw=hw, num_steps=cfg.num_steps,
            capacity=8 * hw * hw,
        )
        planes = aer.input_planes(stream, cfg.num_steps, hw * hw,
                                  polarity_mode="on_only").cpu().numpy()
        # the "collision sensor" traffic class: tight deadline, priority,
        # admitted ahead of the queued rate-coded tail
        dvs_reqs = [StreamRequest(spikes=planes[:, i], deadline_s=2.0,
                                  priority=1) for i in range(n_dvs)]

    # async admission: rate-coded requests first, then the DVS burst lands
    # mid-flight after a couple of scheduler rounds
    for r in rate_reqs:
        engine.submit(r)
    results = engine.poll() + engine.poll()
    for r in dvs_reqs:
        engine.submit(r)
    results += engine.drain()
    results.sort(key=lambda r: r.request_id)
    kinds = ["rate"] * n_rate + ["dvs"] * n_dvs

    snap = engine.metrics_snapshot()
    print(f"served {len(results)} requests ({n_rate} rate-coded, {n_dvs} "
          f"DVS) on {args.slots} slots, backend {engine.backend} on "
          f"{device.type}")
    print("metrics snapshot (registry histograms, per request):")
    for key, unit, scale in (
        ("engine.request.latency_s", "ms", 1e3),
        ("engine.request.queue_wait_s", "ms", 1e3),
        ("engine.request.energy_pj", "nJ", 1e-3),
    ):
        h = snap[key]
        print(f"  {key}: p50={h['p50']*scale:.1f}{unit} "
              f"p90={h['p90']*scale:.1f}{unit} "
              f"p99={h['p99']*scale:.1f}{unit} (n={h['count']})")
    print(f"  deadline misses: "
          f"{snap['engine.requests.deadline_missed']['value']:.0f}"
          f"/{snap['engine.requests.completed']['value']:.0f} | "
          f"throughput {engine.events_per_sec():.0f} events/s over "
          f"{engine.total_steps} slot-steps")
    ts = engine.timeseries
    print(f"time series ({len(ts)} samples over {ts.span_s():.2f}s): "
          f"windowed miss-rate {engine.windowed_miss_rate(1.0):.1%}, "
          f"{ts.rate('engine.episode.events', 1.0):.0f} events/s (1s)")

    # the paper's claim in miniature: sparse DVS inputs cost far less than
    # dense-ish rate coding at one network shape (45 nm model estimate)
    for kind in ("rate", "dvs"):
        sel = [r for r in results if kinds[r.request_id] == kind]
        if not sel:
            continue
        e = np.mean([r.energy_pj for r in sel])
        rt = np.mean([r.spike_rate for r in sel])
        print(f"  {kind:4s}: mean input rate {rt:.3f}, "
              f"mean modelled energy {e/1e3:.1f} nJ/inference")

    health = engine.health()
    fired = [f"{s['name']}:{s['status']}"
             for s in health["slos"] if s["status"] != "healthy"]
    print(f"SLO verdict: {health['status'].upper()}"
          + (f" ({', '.join(fired)})" if fired else "")
          + f" — {len(health['slos'])} SLOs evaluated over "
            f"{health['span_s']:.2f}s of samples")


if __name__ == "__main__":
    main()
