"""Serving launcher on the card: batched LM generation (the default) or
streaming SNN inference (``--snn``).

LM zoo (prefill + step-synchronous batched decode, ``ServeEngine``):

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-130m \
      --reduced --requests 8 --new-tokens 16 [--batch 4] [--cache-len 128] \
      [--temperature 0.8] [--quant q115] [--device cuda|cpu]

The arch's config is always cut to its ``reduced()`` size (``--reduced``
is on by default and cannot be turned off, as in the reference); weights
are random, made from seed 0; prompts are 4-23 random tokens (and, for
the vlm arch, random CLIP patch embeddings).  It prints one summary line.
Like ``--snn``, it runs on the card unless ``--device cpu`` is given.

SNN streaming:

  PYTHONPATH=src python -m repro_torch.launch.serve --snn --requests 16 \
      --batch 8 --image-hw 64 --hidden 512 --num-steps 25 --chunk-steps 5 \
      [--dvs --polarity two_channel|signed|on_only] \
      [--snn-backend fused|torch|auto] [--no-pipeline] [--deadline-ms 50] \
      [--arrival-rate 400] [--drain-timeout 30] \
      [--max-queue 16] [--shed] [--inject-faults 4 --fault-seed 0] \
      [--snapshot-dir DIR --snapshot-every 0.5] [--restore] [--preempt] \
      [--metrics-json m.json] [--trace-out t.json] [--timeseries-out s.jsonl] \
      [--profile-ticks 20 --profile-dir DIR] [--device cuda|cpu]

Requests are rate-coded images of the synthetic collision dataset, or
with ``--dvs`` synthetic DVS recordings as polarity-aware input planes
(``--polarity two_channel`` doubles the input layer, ``signed`` feeds
{-1, 0, +1} spikes through shared rows, ``on_only`` keeps ON events); the
network's weights are random, made from a seed.  The latency SLO's p99
target is the ``--deadline-ms`` budget (1 s without one).  Closed loop by default;
``--arrival-rate`` submits them open-loop at Poisson arrival times.  The
fault-tolerance flags are the reference launcher's: a bounded admission
queue and feasibility shedding, seeded chaos, rotating snapshots with a
warm restart, and deadline-aware preemption.  Runs on the card unless
``--device cpu`` is given, and fails rather than fall back to the CPU.
The summary splits the results into ``ok | shed | quarantined`` and reads
the engine's metrics snapshot, its SLO verdict (``engine.health()``) and
its tick-phase breakdown.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import snn
from repro_torch.data import collision
from repro_torch.events import aer
from repro_torch.obs import default_slos
from repro_torch.serving.snn_engine import (
    EngineStallError,
    SNNStreamEngine,
    StreamRequest,
    resolve_device,
)


def _fault_plane(args, cfg):
    """The admission policy and the seeded fault injector the flags ask
    for (None when off)."""
    admission = injector = None
    if args.max_queue > 0 or args.shed:
        from repro_torch.faults import AdmissionPolicy

        admission = AdmissionPolicy(
            max_queue_depth=args.max_queue if args.max_queue > 0 else None,
            shed_unmeetable=args.shed,
        )
    if args.inject_faults > 0:
        from repro_torch.faults import FaultInjector, FaultSchedule

        chunks = -(-cfg.num_steps // args.chunk_steps)
        horizon = max(2 * args.requests * chunks // max(args.batch, 1), 8)
        injector = FaultInjector(FaultSchedule.generate(
            args.fault_seed, args.inject_faults, ticks=horizon,
            num_slots=args.batch, num_layers=cfg.num_layers,
            kinds=("nan_membrane", "corrupt_ring", "chunk_exception"),
        ))
    return admission, injector


def _serve_loop(args, engine, reqs):
    """Serve ``reqs``: open loop at Poisson arrivals (``--arrival-rate``),
    or closed loop; snapshots on the ``--snapshot-every`` cadence, and a
    bounded drain (``--drain-timeout``) that reports the stuck slots."""
    snap_t = [time.perf_counter()]

    def maybe_snapshot():
        if not args.snapshot_dir or args.snapshot_every <= 0:
            return
        if time.perf_counter() - snap_t[0] >= args.snapshot_every:
            engine.snapshot_auto(args.snapshot_dir)
            snap_t[0] = time.perf_counter()

    def stalled(slots):
        print(f"snn: STALLED after {args.drain_timeout:.1f}s — stuck "
              f"slots: {slots}")

    if args.arrival_rate > 0:
        # open loop: Poisson arrivals at the requested rate, submitted to
        # the engine while earlier requests' chunks are in flight
        gaps = np.random.default_rng(3).exponential(
            1.0 / args.arrival_rate, len(reqs))
        arrivals = np.cumsum(gaps)
        results, i = [], 0
        start = time.perf_counter()
        while i < len(reqs) or not engine.idle():
            now = time.perf_counter() - start
            while i < len(reqs) and arrivals[i] <= now:
                engine.submit(reqs[i])
                i += 1
            if engine.idle() and i < len(reqs):
                time.sleep(max(arrivals[i] - (time.perf_counter() - start),
                               0.0))
                continue
            results.extend(engine.poll())
            maybe_snapshot()
        return sorted(results, key=lambda r: r.request_id)
    for r in reqs:
        engine.submit(r)
    if args.snapshot_dir and args.snapshot_every > 0:
        # closed loop with a live snapshot cadence: poll by hand so the
        # engine can snapshot between ticks
        results, t_start = [], time.perf_counter()
        while not engine.idle():
            if (args.drain_timeout > 0
                    and time.perf_counter() - t_start > args.drain_timeout):
                stalled(engine.stall_snapshot()["slots"])
                break
            results.extend(engine.poll())
            maybe_snapshot()
        return sorted(results, key=lambda r: r.request_id)
    try:
        results = engine.drain(
            timeout_s=args.drain_timeout if args.drain_timeout > 0 else None)
    except EngineStallError as e:
        stalled(e.snapshot["slots"])
        results = list(e.results)
    return sorted(results, key=lambda r: r.request_id)


def _requests(args, cfg, device):
    """The requests the flags ask for, and the source they name: rate-coded
    images of the collision dataset, or (``--dvs``) synthetic DVS
    recordings densified into polarity-aware input planes, drawn from a
    seeded generator as the reference draws them from a seeded key."""
    hw = args.image_hw
    if args.dvs:
        gen = torch.Generator(device=device).manual_seed(2)
        stream, _ = aer.dvs_collision_batch(
            gen, args.requests, image_hw=hw, num_steps=cfg.num_steps,
            capacity=8 * hw * hw,
        )
        planes = aer.input_planes(
            stream, cfg.num_steps, hw * hw, polarity_mode=args.polarity
        ).cpu().numpy()
        reqs = [StreamRequest(spikes=planes[:, i])
                for i in range(args.requests)]
        return reqs, f"dvs-events/{args.polarity}"
    data_cfg = collision.CollisionConfig(
        image_hw=hw, num_train=0, num_test=args.requests
    )
    _, _, test_x, _ = collision.generate(data_cfg)
    return [StreamRequest(image=x.reshape(-1)) for x in test_x], "rate-coded"


def lm_requests(cfg, n: int, new_tokens: int, temperature: float = 0.0,
                seed: int = 0):
    """The LM mode's requests: prompts of 4-23 random tokens (codebook
    rows for an audio arch) and, for a vlm arch, random CLIP patch
    embeddings, from ``default_rng(seed)``."""
    from repro_torch.models.model import CLIP_EMBED_DIM
    from repro_torch.serving.engine import Request

    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n):
        L = int(rng.integers(4, 24))
        shape = (L, cfg.num_codebooks) if cfg.num_codebooks else (L,)
        img = None
        if cfg.num_image_tokens:
            img = rng.normal(0, 1, (cfg.num_image_tokens, CLIP_EMBED_DIM)
                             ).astype(np.float32)
        reqs.append(Request(
            prompt=rng.integers(0, cfg.vocab_size, shape).astype(np.int32),
            max_new_tokens=new_tokens, temperature=temperature,
            img_embeds=img))
    return reqs


def _serve_lm(args) -> None:
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServeEngine

    device = resolve_device(args.device)
    cfg = configs.get(args.arch).reduced()
    if args.quant:
        cfg = dataclasses.replace(cfg, quant=args.quant)
    model = Model(cfg)
    params = model.init(0, device)
    engine = ServeEngine(model, params, batch_size=args.batch,
                         cache_len=args.cache_len)
    reqs = lm_requests(cfg, args.requests, args.new_tokens, args.temperature)
    t0 = time.time()
    outs = engine.generate(reqs)
    dt = time.time() - t0
    n = sum(len(o) for o in outs)
    where = ("CPU" if device.type == "cpu"
             else torch.cuda.get_device_name(device))
    print(f"{args.arch}: served {len(reqs)} reqs / {n} tokens in {dt:.2f}s "
          f"({n/dt:.1f} tok/s on {where}, quant={cfg.quant})")


def _serve_snn(args) -> None:
    device = resolve_device(args.device)
    if args.requests <= 0:
        print("snn: nothing to serve (--requests 0)")
        return
    hw = args.image_hw
    # DVS ON/OFF events get their own input channels (or signed weights);
    # frame-camera mode keeps hw*hw inputs
    input_size = (
        aer.input_size_for(hw * hw, args.polarity) if args.dvs else hw * hw
    )
    cfg = snn.SNNConfig(
        layer_sizes=(input_size, args.hidden, 2), num_steps=args.num_steps
    )
    params = snn.init_params(torch.Generator().manual_seed(0), cfg, device)
    admission, injector = _fault_plane(args, cfg)
    deadline_s = args.deadline_ms / 1e3 if args.deadline_ms > 0 else None
    engine = SNNStreamEngine(
        params, cfg, num_slots=args.batch, chunk_steps=args.chunk_steps,
        seed=1, backend=args.snn_backend,
        pipeline_depth=0 if args.no_pipeline else 1,
        # the latency SLO's target follows the deadline budget (1 s
        # without one), as in the reference launcher
        slos=default_slos(p99_target_s=deadline_s or 1.0),
        admission=admission, injector=injector, preempt=args.preempt,
        device=device,
    )
    if args.restore:
        # warm restart from the newest intact snapshot (corrupt or partial
        # ones are skipped with a warning)
        if not args.snapshot_dir:
            raise SystemExit("--restore requires --snapshot-dir")
        restored = engine.restore_latest_snapshot(args.snapshot_dir)
        if restored is not None:
            print(f"snn: warm-restarted from {restored} (resident slots "
                  f"resume mid-window)")
        else:
            print(f"snn: no usable snapshot under {args.snapshot_dir}; "
                  f"cold start")
    reqs, source = _requests(args, cfg, device)
    if deadline_s is not None:
        reqs = [dataclasses.replace(r, deadline_s=deadline_s) for r in reqs]

    profile = None
    if args.profile_ticks > 0:
        from repro_torch.obs import profile_ticks

        profile = profile_ticks(
            engine, args.profile_dir, num_ticks=args.profile_ticks
        )

    t0 = time.time()
    results = _serve_loop(args, engine, reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    if profile is not None:
        profile.stop()
    # latency, energy and throughput over served requests only: shed ones
    # never ran, quarantined ones carry their fault code, not outputs
    ok = [r for r in results if r.disposition == "ok"]
    n_shed = sum(r.disposition == "shed" for r in results)
    n_quar = sum(r.disposition == "quarantined" for r in results)
    rate = np.array([r.spike_rate for r in ok]) if ok else np.zeros(1)
    events_total = float(sum(r.events_per_layer.sum() for r in ok))
    loop = (f"open-loop {args.arrival_rate:.0f} req/s"
            if args.arrival_rate > 0 else "closed-loop")
    print(
        f"snn[{input_size}->{args.hidden}->2, T={cfg.num_steps}, {source}]: "
        f"served {len(results)} reqs in {dt:.2f}s on {args.batch} slots "
        f"({loop}) (ok {len(ok)} | shed {n_shed} | quarantined {n_quar})"
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
    if admission is not None or injector is not None or n_shed or n_quar:
        print(
            f"  fault plane: shed {n_shed} ({engine.shed_rate():.1%} of "
            f"submitted) | parked served {sum(r.parked for r in ok)} | "
            f"quarantined {n_quar} | injected "
            f"{int(snap['engine.faults.injected']['value'])} | retries "
            f"{int(snap['engine.faults.chunk_retries']['value'])} | "
            f"demotions {int(snap['engine.faults.backend_demoted']['value'])}"
        )
    if args.preempt or args.snapshot_dir:
        print(
            f"  crash safety: preempt parked "
            f"{int(snap['engine.preempt.parked']['value'])} / resumed "
            f"{int(snap['engine.preempt.resumed']['value'])} | snapshots "
            f"{snap['engine.snapshot.save_s']['count']} | restores "
            f"{snap['engine.snapshot.restore_s']['count']}"
        )
    print(
        f"  measured energy/inference: mean {en['mean']/1e3:.1f} nJ, "
        f"p99 {en['p99']/1e3:.1f} nJ (model estimate from counted events) "
        f"| {engine.dispatched_ticks} ticks on backend {engine.backend}"
        + (f", {engine.graph_replays} graph replays, "
           f"{engine.graph_captures} capture(s), admission "
           f"{engine.admit_replays} replays of {engine.admit_captures} "
           f"capture(s), {engine.steady_state_recompiles()} steady-state "
           f"re-captures"
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
    # LM mode (the default)
    ap.add_argument("--arch", default="stablelm-1.6b",
                    choices=configs.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--quant", default=None, choices=[None, "q115"])
    # streaming SNN mode
    ap.add_argument("--snn", action="store_true",
                    help="serve the event-driven SNN instead of an LM")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests (LM) or slots (--snn) "
                         "served together")
    ap.add_argument("--dvs", action="store_true",
                    help="synthetic DVS event-camera input instead of "
                         "rate-coded images")
    ap.add_argument("--polarity", default="two_channel",
                    choices=list(aer.POLARITY_MODES),
                    help="DVS ON/OFF event mapping onto the input layer "
                         "(with --dvs)")
    ap.add_argument("--image-hw", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--num-steps", type=int, default=25)
    ap.add_argument("--chunk-steps", type=int, default=5)
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request latency budget in ms (0 = none)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="open-loop Poisson arrival rate in req/s "
                         "(0 = closed loop)")
    ap.add_argument("--drain-timeout", type=float, default=0.0,
                    help="closed-loop drain timeout in seconds; on expiry "
                         "print the stuck slots instead of hanging "
                         "(0 = wait forever)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bound the admission queue at N (overflow sheds "
                         "priority-0 requests, parks higher priorities; "
                         "0 = unbounded)")
    ap.add_argument("--shed", action="store_true",
                    help="EDF feasibility shedding: refuse requests whose "
                         "deadline is provably unmeetable at the measured "
                         "tick rate")
    ap.add_argument("--inject-faults", type=int, default=0,
                    help="chaos: inject N seeded faults (NaN membranes, "
                         "corrupt rings, transient chunk exceptions)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="seed of the --inject-faults schedule")
    ap.add_argument("--snapshot-dir", default=None,
                    help="directory of rotating engine snapshots (atomic "
                         "snap_* dirs, keep 3)")
    ap.add_argument("--snapshot-every", type=float, default=0.0,
                    help="snapshot cadence in seconds while serving "
                         "(0 = never; needs --snapshot-dir)")
    ap.add_argument("--restore", action="store_true",
                    help="warm-restart from the newest intact snapshot "
                         "under --snapshot-dir before serving")
    ap.add_argument("--preempt", action="store_true",
                    help="deadline-aware preemption: a more urgent "
                         "arrival with no free slot parks the loosest "
                         "resident window and resumes it later, "
                         "bit-exactly")
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
    if args.snn:
        _serve_snn(args)
    else:
        _serve_lm(args)


if __name__ == "__main__":
    main()
