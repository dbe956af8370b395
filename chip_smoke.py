"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. Environment: the card's name and power limit (nvidia-smi), torch, CUDA
   and nvcc versions.
2. Build: every kernel under ``src/repro_torch/kernels/csrc`` with nvcc,
   one process per source, all started together.  Then
   ``python -m repro_torch.analysis`` in a process of its own: the lint of
   ``src/repro_torch`` (its graph bodies listed) and the kernels' launch
   budgets with registers, spills and static shared memory from this
   build's ``ptxas`` reports; any finding fails the run.
3. Kernel against plain version: ``snn_chunk`` on the card at the
   collision network's full width (4096-512-2, 8 slots, Tc = 5, C = 4096)
   over rate-coded trains of the collision images, across neuron modes and
   layouts, and at the trainer's ``evaluate`` shape (B = 32, Tc = 25).
   Spikes, events, refractory counters and membranes must equal the plain
   version's exactly.  Prints the launch geometry (cluster, CTAs, step
   block), times the kernel (device time) and its plain version, and computes the kernel's bound from this run's inputs.
4. Main path: ``SNNStreamEngine`` on the card with ``backend="fused"``
   serves 32 image requests and 16 spike-train requests with ragged
   windows, each tick a replay of one captured CUDA graph of the chunk,
   each admission a replay of the admission graph of its (kind, T):
   captures must equal the distinct signatures, and serving the same
   requests again captures nothing.  Prints where the wall time goes
   (ticks, admission with its captures, the rest) for the graph engine's
   first and second serve and the eager engine, the enqueue time of one
   admission replay, and runs one steady admission and its tick under
   ``set_sync_debug_mode("error")``.
   Checks every result; checks that launches a replay x replays equals
   the dispatched ticks, one eager warm-up launch a capture, and no
   steady-state re-capture; prints ms/tick, req/s and ``tick_breakdown``
   beside the same run on the eager engine (``cuda_graph=False``), which
   must give identical results, and that neither engine retried or
   demoted a chunk; checks that an engine forced onto the
   plain version gives identical results for the spike requests; runs
   one steady tick under ``torch.cuda.set_sync_debug_mode("error")``
   (one stats read, no device allocation); prints
   ``dispatch_attribution`` of the chunk as a graph replay and eagerly;
   and profiles both engines (the card's busy share, and the profiler's
   count of kernel records as a second witness of the launches).
5. Kernel against plain version: ``aer_spike_matmul_batched`` on the card
   at the training shapes (B = 32; layer 0, K = 4096, N = 512, on a dense
   early DVS step and a sparse late one; layer 1, K = 512, N = 2), float32
   with max abs difference 0 and int16 bit-exact, and ``aer_spike_matmul``
   (one stream of the dense step, int16).  Prints the batch's live events
   a step, and each case's launch plan and variant (``merged``,
   ``narrow``, ``split``); times the kernel (device time a call, and its
   own kernel alone), its plain version and ``F.embedding_bag`` (the
   library yardstick) in every case, and computes the bound from this
   run's events.
6. Training path: ``EventTrainer`` at 4096-512-2, T = 25, B = 32, signed
   DVS, every layer's forward through the kernel, its default step
   (``jit=True, donate=True``) one CUDA graph replay over state updated in
   place, then one ``evaluate`` through ``snn_chunk``.  20 steps in log
   windows of 5, graphed, graphed again and eager (``jit=False``) from one
   seed: params, Adam state and every metric bit-identical at every
   window.  Checks finite losses, 1 capture and no re-capture
   (``RecompileDetector``), the aer launches captured x replays = steps x
   T x L plus one warm-up step's eager launches, a steady replay under
   ``torch.cuda.set_sync_debug_mode("error")``, one step bit-equal in
   loss and gradients to the same step on the plain version, and
   ``evaluate``'s one ``snn_chunk`` launch; prints ms/step of both runs
   (in ``run()`` and of the step alone) and a ``torch.profiler``
   breakdown of 2 graphed steps in ``run()``, 2 graphed steps alone and 2
   eager steps (the card's busy share, the aer kernel's device time split
   by variant: layer 0, layer 1).
7. Hardware path (the public kernel API, ``repro_torch.kernels.ops``):
   ``ops.snn_layer_forward`` layer by layer at 4096-512-2, T = 25, B = 8
   over deterministically rate-coded collision images, with refractory 0
   and 5 (2 ``spike_matmul`` + 2 ``lif_fused`` launches a forward, the
   LIF kernel fed the adder tree's int32 sums), then
   ``ops.aer_spike_matmul`` on the busiest coded step of each frame and
   ``ops.q115_matmul`` at the hardware path's and kernel_bench's shapes.
   Checks the launch counts, output spike trains equal to the same
   forward through the plain versions, and prints the wall time per
   forward, the table-4 op count from ``hidden_spike_rates``, and the
   device time and device operations of one forward (``torch.profiler``)
   beside the same forward with the bias add, conversion and divide as
   three eager ops before a float LIF launch (the former dataflow).
8. Kernels against plain versions at the hardware path's shapes:
   ``lif_fused`` in both input forms (float currents; int32 sums and
   bias), reset zero and subtract, refractory 0 and 5, ``spike_matmul``
   (both layers), ``aer_spike_matmul`` (each frame's busiest step, also
   against ``spike_matmul`` on the same row) and ``q115_matmul``
   (saturate True and False, both shapes, launch plan printed), all
   bit-exact; times each kernel, its plain version and its library
   yardstick where one PyTorch call computes the same function, and
   computes its bound.  Also times an empty kernel on the LIF kernel's
   grid (the LIF kernel's floor) and the ``q115_matmul`` inner loop's
   instruction pair alone on every SM (the rate its bound assumes).
9. Faults, admission, preemption and snapshots on the graph engine at
   full width (4096-512-2, 8 slots, Tc = 5), spike requests only, each
   check against a run of the same requests: chaos (48 requests under a
   seeded schedule of 2 NaN membranes, 2 corrupt rings and 2 transient
   chunk exceptions; quarantines equal the faulted requests, every other
   result equals the fault-free graph run's, retries equal the injected
   raises, no re-capture); demotion (a persistent fused-only exception
   demotes the engine to ``torch`` with one warning, its results equal
   the plain chunk's); admission (a burst of 48 against a queue of 8
   sheds and parks as the same burst does on the CPU; ``shed_rate()``);
   preemption (tight windows park a loose one, results equal the run
   without preemption, and the steady tick after the resume reads the
   host once and allocates nothing; park and resume p50 in µs); snapshot
   (mid-run with a queue and a parked window, restored into an engine
   that has captured, equal to the uninterrupted run, no re-capture; a
   corrupt newest snapshot of two falls back; snapshot ms, bytes on disk
   and restore ms).  Every phase without injected faults is checked for
   0 retries and 0 demotions, and its replays against its ticks.
10. The event input path, at full width: (a) 48 synthetic 64x64 DVS
   recordings served by the graph engine as signed planes (4096-512-2)
   and as two-channel planes (8192-512-2), each equal in every field to
   the eager engine and to the engine on the plain chunk, with 0
   re-captures and launches equal to replays plus warm-ups; ms/tick,
   req/s, events/s and mean modelled energy beside phase 4's rate-coded
   requests.  (b) ``capacity.autotune`` (defaults) on the counts of the
   48 measured through ``backend="fused"``, for both input layers: the
   counts must equal the plain chunk's (``"fused_ref"``), their layer-0
   counts and the plan those through ``"torch"``, whose hidden counts
   may differ where a membrane sits within rounding of the threshold
   (its layer-0 sums run in another order: printed, not gated); the
   engine at the plan that shrinks layer 0 serves the 48 equal to the
   untuned engine; ``snn_chunk``'s device time at the tuned C and at
   fan-in (equal outputs), the staged ring bytes of both;
   ``truncation_report`` on 16 held-out recordings, fused equal to the
   plain chunk's (torch's printed beside it), and the tuned engine's
   ``capacity_overflow`` quarantines on them.  (c) ``event_forward_aer`` on 32 of the recordings as AER
   streams: T x L aer launches, equal to the same call on the kernel's
   plain version, spikes and events equal to ``event_forward`` (fused)
   on the densified planes and membranes within 1e-5; ms a window and
   the aer kernel's device time a window.  (d) the BCNN (64x64, 16-32-64)
   on 64 collision images on the card with TF32 off, within 1e-4 of the
   CPU; one training step's loss finite; ``energy_reduction`` of the
   measured DVS events against the BCNN baselines (a 45 nm model).
11. The LM zoo's serving path (``ServeEngine`` on ``repro_torch.models``;
   none of the six kernels runs on it, and their launch counts must stay
   0; its one kernel is ``decode_attention``, the decode step's attention
   over a full bfloat16 cache).  First that kernel alone at the LM serving
   cell's shape (B 32, a cache of 1,280 rows, 32 kv heads of 64, 1,152
   valid rows): its device time a launch beside its bytes bound (the
   valid K and V rows once), ``attend_full`` (the plain version) and
   ``F.scaled_dot_product_attention`` (the library yardstick, timed only;
   the port never calls it), held to 99 % of outputs within one bfloat16
   ulp of ``attend_full``.  Then ``stablelm-1.6b`` at full width (24 layers, d_model 2048, vocab
   100,352; 1,644,515,328 float32 params drawn on the card from a seed),
   bfloat16 compute, ``ServeEngine(batch_size=4, cache_len=128)`` on 8
   requests of 4-23 tokens x 16 new tokens, greedy: first the eager
   engine (``cuda_graph=False``), then the graphed one (prefill and decode
   replayed as CUDA graphs over a static cache): a cold serve that
   captures exactly one graph a signature and a warm serve that captures
   none (``RecompileDetector``), both token for token equal to the eager
   serve; the first batch's prefill logits and every decode step's logits
   replayed equal to the eager engine's bit for bit.  For both: tokens/s
   (the graphed cold and warm serves), prefill ms and ms a decode step
   (CUDA events: median and spread), device operations and device ms a
   step and the busy share over two traced steps (``torch.profiler``), a
   greedy step under ``set_sync_debug_mode("error")``, peak allocated and
   reserved memory; the ms of each capture; ``decode_attention``'s
   counters over the bfloat16 serves (held: each decode capture records
   one launch a layer, and no decode call falls back to ``attend_full``).
   Beside it the absorbed-MLA decode kernel (``mla_decode``) alone at the
   DeepSeek serving cell's shape (B 128, a cache of 1,536 rows, 16 heads
   of rank 512 and rope 64, 1,280 valid rows; four caches in turn, so each
   call reads cold rows): its device time a launch beside its one-read
   bytes bound, the bound of reading c_kv twice and ``_mla_latent`` (the
   plain version), held to 99 % of outputs within one bfloat16 ulp of it.
   The gate: the same params
   and requests served in float32 compute with TF32 off (graphed, and
   equal to eager), and the teacher-forced forward over each batch's
   right-padded prompts and generated tokens; its argmax at every
   generated position must be the generated token (positions with a
   top-2 gap under 1e-3 skipped and counted); the largest prefill/decode
   logit difference from the forward is printed, not gated.  Then the
   same check at full width, float32, 2 requests x 4 tokens, graphed
   equal to eager, for one arch of each other family:
   ``granite-moe-1b-a400m`` (no drops), ``mamba2-130m``,
   ``recurrentgemma-2b``, ``minicpm3-4b``, ``phi-3-vision-4.2b`` (576
   image embeddings a request) and ``musicgen-medium`` (4 codebooks);
   ``mixtral-8x7b`` and ``yi-34b`` (187 and 138 GB of float32 params) and
   ``codeqwen1.5-7b`` (dense, as stablelm) run reduced only.  Then all
   ten archs at ``reduced()``: prefill + decode within 5e-4 of the
   forward, the graphed engine's tokens equal the eager one's on the
   launcher's requests (greedy; and sampled at temperature 0.8 under
   q115 on stablelm, one seed for both), and ``python -m
   repro_torch.launch.serve``'s LM mode in process, graphed by default
   (``--temperature 0.8 --quant q115`` on stablelm), and
   ``repro_torch.examples.serve_quantized_lm --q115`` (3 requests x 4
   tokens) in process, graphed by default.
12. The LM zoo's training path (``Model.loss`` under the launcher's
   ``Trainer``; none of the six kernels runs on it, and their launch
   counts must stay 0). (a) ``stablelm-1.6b`` at full width and depth,
   float32 params, bfloat16 compute, ``remat="full"``, batch 4 x 128
   tokens of the launcher's Markov batches, the launcher's AdamW chain,
   ``Trainer(jit=True, donate=True)``: 12 steps, 1 capture and 12 replays
   gated, every loss finite, peak allocated memory under the card's;
   prints ms a step (CUDA events: median and spread), tokens/s, the first
   step's time (warm-up and capture), device time and device operations a
   step and the busy share over 2 traced steps (``torch.profiler``; the
   matmul kernels' part by name), peak allocated and reserved memory, the
   first and last loss; then the optimizer's leaf-by-leaf step alone
   (CUDA events) and the same training step with ``remat="none"`` (what
   the recompute costs). (c) One eager full-width step (``jit=False``)
   under ``set_sync_debug_mode("error")``. (b) Graphed equals eager bit
   for bit: 3 steps each from the same params and batches, params, Adam
   state and losses, for stablelm and one arch of each other family
   (phase 11's), each at full width with its depth cut to one repeat of
   its layer group, float32 compute, TF32 off, and stablelm again under
   the launcher's ``--quant q115`` (fake quantization in the step). (d)
   ``python -m repro_torch.launch.train --arch stablelm-1.6b --reduced
   --steps 3`` in a process: ``final:`` and ``captures 1, graph replays
   3``.
14. (Runs after 12, before the table.)  Slot sharding and the pipeline
   (``repro_torch.distributed``): ``SNNStreamEngine`` at the collision
   network's full width (4096-512-2, T = 25, Tc = 5, 8 slots,
   ``backend="fused"``, graphed) unsharded, with a ``Mesh`` of ``cuda:0``
   twice (``("data",)``: 2 shards x 4 slots) and four times (4 x 2), each
   on phase 4's 48 requests.  Every result equals the unsharded graph
   engine's in every field; ``snn_chunk`` launches = shards x dispatched
   ticks (each shard's graph replayed every tick, one launch a replay)
   plus one warm-up launch a capture; tick captures = shards, admission
   captures = the (shard, kind, T) signatures, covering every (kind, T);
   a second serve captures nothing and equals the first on the spike
   requests; no retry, no demotion, no re-capture.  Prints ms/tick of a
   captured serve of 1, 2 and 4 shards, three runs each in turns
   (ungated), beside phase 4's.  A snapshot taken after 6 ticks on 2
   shards restores into a 1-shard and a 4-shard engine, each finishing
   equal to the uninterrupted run; 3 slots over 2 shards raise
   ``ValueError`` naming ``num_slots``.  ``pipeline_forward`` over a
   4-stage mesh of ``cuda:0`` (``tanh(x @ w)``, d = 2048, 8 microbatches
   of 4, float32, TF32 off) within 1e-5 of the sequential composition.
15. (Runs after 14, before the table.)  The dry run
   (``repro_torch.launch.dryrun``, every tensor on ``meta``): ``python -m
   repro_torch.launch.dryrun``'s ``main`` plans ``stablelm-1.6b`` x
   ``train_4k``, ``prefill_32k`` and ``decode_32k``, ``mixtral-8x7b`` x
   ``long_500k`` and ``--arch collision-snn`` on the single mesh (each
   ``ok``, each step partitioned as DTensors over a ``fake`` process
   group of 256 ranks; the SNN cell's collectives by kind and mesh axis
   and its dominant term printed, its traffic above 0), and records
   ``yi-34b`` x ``long_500k`` as ``skipped``;
   ``torch.cuda.memory_allocated()`` must not change across them and the
   six kernels keep 0 launches.  Then the plan held against the card:
   the train cell of ``stablelm-1.6b`` at phase 12's shape (4 x 128,
   bfloat16 compute, ``remat="full"``) planned on a one-device mesh
   (unsharded, and partitioned on a (1, 1) mesh, whose flops, bytes and
   peak must equal the unsharded plan's with no collective traffic), and
   the same step (``make_step_parts``' device part, ``chain_clip(adam(
   5e-4), 1.0)``, written into the state's own buffers) run once eagerly
   on the card from a fresh peak: the planned peak must be within 15 % of
   ``max_memory_allocated()`` less what was allocated before the step's
   objects.  Prints both beside phase 12's graphed peak, and a second
   eager step's ms (CUDA events) against the cell's roofline bound
   (ungated), and the phase's seconds.
13. Prints the kernel table as one JSON line (the aer row also carries
   the sparse and layer-1 times, every phase-5 case, phase 6's graph
   counts and the inference launches of phase 10; the snn_chunk row phase 10's DVS and tuned-C
   cases and phase 14's launches on 2 and 4 shards; the lif row its
   second form and floor; the q115 row each shape and saturation), then
   ``{"ok": true, ...}`` as the last line.

There is no CPU fallback: without a CUDA device the script exits 2.
"""

from __future__ import annotations

import collections
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SLOTS, TC, SEED = 8, 5, 0
TRAIN_BATCH, TRAIN_STEPS, TRAIN_WINDOW = 32, 20, 5
HW_BATCH = 8  # benchmarks/table4_network.py's batch
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
INT8_TC_OPS = 1979e12  # H100 SXM int8 tensor cores, dense
# int32 lanes of the CUDA cores: 132 SMs x 64 lanes x 1.98 GHz boost (the
# clock at which 128 float32 lanes give the 67 TFLOP/s above)
INT32_OPS = 132 * 64 * 1.98e9
# integer instructions the CUDA cores issue: 132 SMs x 4 sub-partitions x
# one warp instruction (32 lanes) a clock x 1.98 GHz.  q115_matmul's
# product is an IMAD on the FMA pipe and a LEA on the ALU pipe (its SASS),
# 16 lanes a sub-partition each, so the pair is bound by issue, not by
# one pipe's 64 lanes an SM (phase 8 measures the pair's rate)
INT_ISSUE_OPS = 132 * 4 * 32 * 1.98e9


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def weights_np(sizes, seed):
    """Seeded random weights in the reference's layout and init ranges."""
    import numpy as np

    rng = np.random.default_rng(seed)
    params = {}
    for i, (k, n) in enumerate(zip(sizes[:-1], sizes[1:])):
        bound = 1.0 / np.sqrt(k)
        params[f"layer{i}"] = {
            "w": rng.uniform(-bound, bound, (k, n)).astype(np.float32),
            "b": rng.uniform(-bound, bound, n).astype(np.float32),
            "beta_raw": np.full(n, np.log(0.9 / 0.1), np.float32),
            "threshold": np.ones(n, np.float32),
        }
    # an untrained output layer stays silent at threshold 1: lower it so
    # the output spikes, and the paths that follow them, are exercised
    params[f"layer{len(sizes) - 2}"]["threshold"][:] = 0.1
    return params


def images(n, seed):
    from repro_torch.data import collision

    cfg = collision.CollisionConfig(image_hw=64, num_train=0, num_test=n,
                                    seed=seed)
    return collision.generate(cfg)[2].reshape(n, -1)


def cuda_ms(fn, reps=20, rounds=5):
    """Median over ``rounds`` of the mean time of ``reps`` calls, from
    CUDA events, after a warm-up."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_time_us(torch, prof):
    """Device time by name (us) of the kernels, copies and fills a
    ``torch.profiler`` run put on the card.  Only device-side events are
    summed: an operator's own entry repeats the time of the kernels it
    launched, and adding both would count that time twice."""
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", 0.0)
        if us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            out[ev.key] = us
    return out


RECORD_OFFSETS = []  # per_call: each kernel's records less reps x its launches


def per_call(torch, prof, reps, only=None):
    """(device ms, device operations) of one of ``reps`` profiled calls:
    for each kernel, copy or fill name (holding ``only``, if given) its
    mean duration times its launches a call, the number of its records
    over ``reps`` rounded.  A profiler run can lose a record or carry a
    stray few (a 0.5 ms kernel once timed 20-25 % short of its
    CUDA-event time when divided by ``reps``); the mean and the rounding
    take neither into the time.  (None, 0) when no device time was
    recorded."""
    us, ops = 0.0, 0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total", 0.0)
        if (t <= 0 or ev.device_type != torch.autograd.DeviceType.CUDA
                or (only is not None and only not in ev.key)):
            continue
        n = round(ev.count / reps)
        RECORD_OFFSETS.append(ev.count - n * reps)
        us, ops = us + t / ev.count * n, ops + n
    return (us / 1e3 if us > 0 else None), ops


def device_ms(fn, reps=20, only=None, runs=3):
    """Mean device time of one call of ``fn`` (ms): the durations of
    everything its calls ran on the card (or of the kernels whose name
    holds ``only``), from ``torch.profiler`` (``per_call``), so host time
    between launches is left out; the median over ``runs`` profiler runs
    of ``reps`` calls, as a run late in this script can read far off.
    None when the profiler recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms = per_call(torch, prof, reps, only)[0]
        if ms is not None:
            times.append(ms)
    return statistics.median(times) if times else None


def bound_of(nbytes, ops, rate):
    """(bound_by, ms): the larger of bytes over the memory rate and
    operations over ``rate``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / rate * 1e3
    return ("bytes", t_bytes) if t_bytes >= t_ops else ("operations", t_ops)


def chunk_bound(args, events, widths):
    """Least time for one chunk on an H100 SXM: the larger of the bytes it
    must move over the memory rate and its float32 operations over the
    float32 rate, counted from this call's inputs and its measured
    hidden-layer events.  ``l2_gather_bytes`` (information only, not in
    the bound) is what the gather reads through L2: one W0 row per event
    and step, as the kernel reads it."""
    import torch

    weights, biases, betas, thrs, u0, r0, addrs, values, counts, active = args
    B, Tc, C = addrs.shape
    lanes = torch.arange(C, device=addrs.device)
    live = (active != 0)[:, None, None]
    valid = (lanes < counts[:, :, None]) & live
    n_events = int(valid.sum())
    rows = int(torch.unique(addrs[valid].long()).numel())
    N = widths[1:]
    total = sum(N)
    nbytes = (
        rows * N[0] * 4  # the W0 rows this run's events gather
        + sum(int(w.numel()) * 4 for w in weights[1:])
        + 3 * total * 4  # bias, beta, threshold
        + n_events * (addrs.element_size() + values.element_size())
        + counts.numel() * 4 + B * 4
        + 2 * B * total * 8  # incoming and final membranes + counters
        + 2 * Tc * B * N[-1] * 4 + Tc * len(N) * B * 4  # mem, spk, events
    )
    # each input event costs a multiply and an add per output neuron; each
    # neuron update a multiply, two adds and a compare
    hidden = sum(int(events[:, i].sum()) * N[i] for i in range(1, len(N)))
    flops = 2 * n_events * N[0] + 2 * hidden + 4 * Tc * B * total
    return bound_of(nbytes, flops, F32_FLOPS), {
        "events": n_events, "distinct_w0_rows": rows, "bytes": nbytes,
        "l2_gather_bytes": n_events * N[0] * 4, "flops": flops}


def phase_analysis(card):
    """``python -m repro_torch.analysis`` in a process of its own, after
    the build: the lint and the kernels' launch budgets, with registers,
    spills and static shared memory from this build's ptxas reports.
    Returns the kernel plans by name."""
    out = ROOT / "build" / "analysis_report.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--json", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    for line in proc.stdout.splitlines():
        print(f"analysis: {line}")
    if proc.returncode != 0:
        fail(f"python -m repro_torch.analysis exited {proc.returncode}:\n"
             f"{proc.stderr[-4000:]}")
    doc = json.loads(out.read_text())
    plans = {p["kernel"]: p for p in doc["kernels"]}
    unread = [k for k, p in plans.items() if p["registers"] is None]
    if unread or len(doc["graph_bodies"]) != 5:
        fail(f"analysis: no ptxas registers for {unread}, graph bodies "
             f"{doc['graph_bodies']}")
    print(f"analysis: {len(plans)} kernel budgets with registers and spills "
          f"from this build, {doc['counts']['findings']} findings, "
          f"{doc['counts']['suppressed']} suppressed | on {card}")
    return plans


def phase_kernel(torch, dev, params_np, card):
    """Phase 3: the kernel against its plain version at full width."""
    import numpy as np

    from repro_torch.configs.collision_snn import CONFIG
    from repro_torch.core import snn
    from repro_torch.events import runtime
    from repro_torch.kernels import snn_chunk as chunk_mod

    sizes = CONFIG.layer_sizes
    params = snn.params_from_numpy(params_np, dev)
    rng = np.random.default_rng(SEED + 1)
    px = images(SLOTS, SEED + 1)  # one collision image per slot
    train = (rng.random((SLOTS, TC, sizes[0])) < px[:, None, :]).astype(
        np.float32
    )
    silent = train.copy()
    silent[:, 2] = 0.0  # one all-silent step
    tables = {
        name: runtime.encode_step_table(torch.from_numpy(x).to(dev), sizes[0])
        for name, x in (("base", train), ("silent", silent))
    }
    u_rand = [torch.from_numpy(rng.normal(0, 0.4, (SLOTS, n)).astype(
        np.float32)).to(dev) for n in sizes[1:]]
    r_rand = [torch.from_numpy(rng.integers(0, 6, (SLOTS, n)).astype(
        np.int32)).to(dev) for n in sizes[1:]]
    u_zero = [torch.zeros_like(u) for u in u_rand]
    r_zero = [torch.zeros_like(r) for r in r_rand]
    ones = torch.ones(SLOTS, device=dev)
    frozen = ones.clone()
    frozen[3] = 0.0

    def layer_args(p):
        L = len(sizes) - 1
        lp = [p[f"layer{i}"] for i in range(L)]
        return ([x["w"] for x in lp], [x["b"] for x in lp],
                [snn.effective_beta(x) for x in lp],
                [x["threshold"] for x in lp])

    q115 = snn.quantized(params)
    cases = [
        # name, params, u0, r0, table, active, kwargs, layout
        ("lif_zero", params, u_zero, r_zero, "base", ones, {}, "slot_major"),
        ("lif_subtract", params, u_rand, r_zero, "base", ones,
         {"reset": "subtract"}, "slot_major"),
        ("refractory5", params, u_rand, r_rand, "base", ones,
         {"refractory_steps": 5}, "slot_major"),
        ("lapicque", params, u_rand, r_zero, "base", ones,
         {"kind": "lapicque", "lapicque_gain": 0.5}, "slot_major"),
        ("q115", q115, u_zero, r_zero, "base", ones, {}, "slot_major"),
        ("frozen_slot", params, u_rand, r_zero, "base", frozen, {},
         "slot_major"),
        ("silent_step", params, u_rand, r_zero, "silent", ones, {},
         "slot_major"),
        ("time_major", params, u_rand, r_rand, "base", ones,
         {"refractory_steps": 5, "reset": "subtract"}, "time_major"),
    ]
    def check(name, args, layout, kw):
        got = chunk_mod.snn_chunk(*args, layout=layout, **kw)
        ref = chunk_mod.snn_chunk_ref(*args, layout=layout, **kw)
        torch.cuda.synchronize()
        mem, spk, ev, u_fin, r_fin = got
        r_mem, r_spk, r_ev, r_u, r_r = ref
        if not torch.equal(spk, r_spk):
            fail(f"{name}: spikes differ from the plain version")
        if not torch.equal(ev, r_ev):
            fail(f"{name}: events differ from the plain version")
        if not all(torch.equal(x, y) for x, y in zip(r_fin, r_r)):
            fail(f"{name}: refractory counters differ")
        err = max(
            [float((mem - r_mem).abs().max())]
            + [float((x - y).abs().max()) for x, y in zip(u_fin, r_u)]
        )
        if not (torch.equal(mem, r_mem) and
                all(torch.equal(x, y) for x, y in zip(u_fin, r_u))):
            fail(f"{name}: membranes differ from the plain version by up to {err}")
        print(f"kernel[{name}]: events {int(ev[:, 0].sum())} layer-0, "
              f"{int(ev[:, 1:].sum())} hidden | out spikes {int(spk.sum())} | "
              f"spikes/events/refractory/membranes exact")
        return ev, err

    errs = []
    for name, p, u0, r0, tab_name, act, kw, layout in cases:
        tab = tables[tab_name]
        a, v, c = tab.addrs, tab.values, tab.counts
        if layout == "time_major":
            a, v = a.transpose(0, 1).contiguous(), v.transpose(0, 1).contiguous()
            c = c.T.contiguous()
        args = (*layer_args(p), u0, r0, a, v, c, act)
        ev, err = check(name, args, layout, kw)
        errs.append(err)
        if name == "lif_zero":
            timed_args, timed_events = args, ev

    # the trainer's evaluate shape: one chunk of T = 25 steps at B = 32
    Tn = CONFIG.num_steps
    px = images(TRAIN_BATCH, SEED + 7)
    train = (rng.random((TRAIN_BATCH, Tn, sizes[0])) < px[:, None, :]).astype(
        np.float32)
    tab = runtime.encode_step_table(torch.from_numpy(train).to(dev), sizes[0])
    zeros_u = [torch.zeros(TRAIN_BATCH, n, device=dev) for n in sizes[1:]]
    zeros_r = [torch.zeros(TRAIN_BATCH, n, dtype=torch.int32, device=dev)
               for n in sizes[1:]]
    eval_args = (*layer_args(params), zeros_u, zeros_r, tab.addrs, tab.values,
                 tab.counts, torch.ones(TRAIN_BATCH, device=dev))
    eval_events, err = check(f"evaluate_B{TRAIN_BATCH}_T{Tn}", eval_args,
                             "slot_major", {})
    errs.append(err)

    shapes = {"serve": (timed_args, timed_events, SLOTS, TC),
              "evaluate": (eval_args, eval_events, TRAIN_BATCH, Tn)}
    times = {}
    for shape, (args, _, B, T) in shapes.items():
        geo = chunk_mod.plan(sizes, T, B)
        call = lambda: chunk_mod.snn_chunk(*args, layout="slot_major")  # noqa: E731
        times[shape] = kernel_ms(call)
        alone = device_ms(call, only="snn_chunk_kernel")
        print(f"kernel geometry[{shape}]: B={B} Tc={T} cluster "
              f"{chunk_mod.CLUSTER} x {B} slots = {geo.ctas} CTAs, "
              f"{geo.threads} threads, columns per CTA {geo.cols}, step block "
              f"{geo.step_block}, dynamic smem {geo.smem} B | device "
              f"{times[shape]:.4f} ms a call, of which the kernel "
              f"{alone or 0:.4f} ms (the rest: the wrapper's concatenations "
              f"and casts) | on {card}")
    plain = []
    for _ in range(3):
        t0 = time.perf_counter()
        chunk_mod.snn_chunk_ref(*timed_args, layout="slot_major")
        torch.cuda.synchronize()
        plain.append((time.perf_counter() - t0) * 1e3)
    plain_ms = statistics.median(plain)
    call_ms = cuda_ms(lambda: chunk_mod.snn_chunk(*timed_args, layout="slot_major"))
    out = {}
    for shape, (args, events, _, _) in shapes.items():
        (bound_by, bound_ms), work = chunk_bound(args, events, list(sizes))
        out[shape] = {"ms": times[shape], "bound_ms": bound_ms,
                      "bound_by": bound_by}
        print(f"kernel time[{shape}]: snn_chunk {times[shape]:.4f} ms (device)"
              f" | bound {bound_ms:.5f} ms ({bound_by}; {work}) | on {card}")
    print(f"kernel time: snn_chunk per call {call_ms:.4f} ms (CUDA events) | "
          f"plain {plain_ms:.1f} ms (host clock) | on {card}")
    return {"ms": out["serve"]["ms"], "plain_ms": plain_ms,
            "bound_ms": out["serve"]["bound_ms"],
            "bound_by": out["serve"]["bound_by"], "max_abs_err": max(errs),
            "evaluate": out["evaluate"]}


def graph_of(torch, fn, *args):
    """``fn(*args)`` captured as a CUDA graph (after a warm-up call on a
    side stream); returns the graph's ``replay``."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn(*args)
    return graph.replay


def serve_counted(torch, eng, reqs):
    """Serve ``reqs`` to completion with the ``snn_chunk`` counts set to 0
    just before and read just after: (results, wall s, eager launches)."""
    from repro_torch.kernels import snn_chunk as chunk_mod

    chunk_mod.snn_chunk.launches = 0
    chunk_mod.snn_chunk.captured = 0
    t0 = time.perf_counter()
    results = eng.run(reqs)
    torch.cuda.synchronize()
    return results, time.perf_counter() - t0, chunk_mod.snn_chunk.launches


def steady_tick(torch, eng, reqs):
    """Submit ``reqs`` to a graph engine, run its first steady tick under
    ``steady_poll``, check that no chunk or host stats buffer moved, and
    drain."""
    for r in reqs:
        eng.submit(r)
    buffers = [eng._stats.data_ptr()] + [h.data_ptr() for h in eng._host_stats]
    _, reads, allocs = steady_poll(torch, eng, "main path")
    if buffers != ([eng._stats.data_ptr()]
                   + [h.data_ptr() for h in eng._host_stats]):
        fail(f"steady tick: buffers moved: {buffers}")
    eng.drain()
    return reads, allocs


def where_host_time_goes(name, eng, wall, since=0.0):
    """Split a serving run's wall time by the engine's own spans (those
    that start at ``since`` or later): the ticks (``host_prep`` +
    ``dispatch`` + ``stats_fetch``), admission (``stage``: upload, rate
    encoding, packing into the ring, as a graph replay or eagerly, and
    the captures of admission graphs within it, ``admit_capture``), and
    the rest (submit's checks, ``_finalize``, the scheduler, sampling)."""
    spans = [x for x in eng.trace.spans() if x.t0 >= since]

    def durations(kind):
        return sorted(x.t1 - x.t0 for x in spans if x.name == kind)

    disp = durations("dispatch")
    ticks = sum(sum(durations(k)) for k in ("host_prep", "dispatch",
                                             "stats_fetch"))
    stage = durations("stage")
    caps = durations("admit_capture")
    print(f"main path ({name}): wall {wall * 1e3:.1f} ms = ticks "
          f"{ticks * 1e3:.1f} ms (dispatch median "
          f"{disp[len(disp) // 2] * 1e6:.1f} us, longest "
          f"{disp[-1] * 1e3:.2f} ms) + admission {sum(stage) * 1e3:.1f} ms "
          f"({len(stage)} stagings, median {stage[len(stage) // 2] * 1e6:.0f}"
          f" us; of it {len(caps)} admission graph captures "
          f"{sum(caps) * 1e3:.1f} ms) + the rest "
          f"{(wall - ticks - sum(stage)) * 1e3:.1f} ms | {len(stage) / wall:.1f}"
          f" req/s, {wall / max(1, len(disp)) * 1e3:.3f} ms/tick")


def steady_admission(torch, eng, reqs):
    """Admit each of ``reqs`` into an idle graph engine whose admission
    graph of that (kind, T) is captured, one poll each, under
    ``set_sync_debug_mode("error")``: the admission (upload, uniforms,
    slot index, replay) and the tick after it must not synchronise
    implicitly or allocate on the device."""
    for req in reqs:
        if not eng.idle():
            fail("steady admission: the engine is not idle")
        eng.submit(req)
        torch.cuda.synchronize()
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
        replays, captures = eng.admit_replays, eng.admit_captures
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng.poll()
        except RuntimeError as err:
            fail(f"steady admission synchronised implicitly: {err}")
        finally:
            torch.cuda.set_sync_debug_mode(0)
        allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs
        if (eng.admit_replays, eng.admit_captures) != (replays + 1, captures) \
                or allocs:
            fail(f"steady admission: replays {replays} -> "
                 f"{eng.admit_replays}, captures {captures} -> "
                 f"{eng.admit_captures}, {allocs} device allocations")
        eng.drain()
    return len(reqs)


def main_requests():
    """Phase 4's requests: 32 collision images (T = 25) and 16 spike
    trains of the collision frames with ragged windows (5-25 steps)."""
    import numpy as np

    from repro_torch.configs.collision_snn import CONFIG
    from repro_torch.serving.snn_engine import StreamRequest

    K = CONFIG.layer_sizes[0]
    rng = np.random.default_rng(SEED + 2)
    img_reqs = [StreamRequest(image=x) for x in images(32, SEED + 2)]
    px = images(16, SEED + 3)
    steps = rng.integers(5, CONFIG.num_steps + 1, 16)
    spike_reqs = [
        StreamRequest(
            spikes=(rng.random((int(T), K)) < x).astype(np.float32),
            num_steps=int(T),
        )
        for x, T in zip(px, steps)
    ]
    return img_reqs, spike_reqs


def phase_main(torch, dev, params_np, card):
    """Phase 4: the serving engine on the card, its tick a CUDA graph
    replay through the kernel."""
    import numpy as np

    from repro_torch.configs.collision_snn import CONFIG
    from repro_torch.core import snn
    from repro_torch.obs import dispatch_attribution
    from repro_torch.serving.snn_engine import SNNStreamEngine

    params = snn.params_from_numpy(params_np, dev)
    img_reqs, spike_reqs = main_requests()

    def engine(backend, **kw):
        return SNNStreamEngine(params, CONFIG, num_slots=SLOTS,
                               chunk_steps=TC, backend=backend, device=dev,
                               **kw)

    engine("fused").run(spike_reqs[:2])  # warm-up: allocator, build, capture
    torch.cuda.synchronize()

    def serve(eng):
        return serve_counted(torch, eng, img_reqs + spike_reqs)

    eng = engine("fused")
    results, wall, eager = serve(eng)
    per = eng.graph_launches_per_replay
    if not eng.graphed or eng.graph_captures < 1 or per != 1:
        fail(f"the engine did not run its tick as a graph: graphed "
             f"{eng.graphed}, captures {eng.graph_captures}, kernel "
             f"launches a replay {per}")
    if per * eng.graph_replays != eng.dispatched_ticks:
        fail(f"{per} snn_chunk launch(es) a replay x {eng.graph_replays} "
             f"replays != {eng.dispatched_ticks} dispatched ticks")
    if eager != eng.graph_captures:
        fail(f"{eager} eager snn_chunk launches for {eng.graph_captures} "
             f"capture(s): one warm-up launch a capture expected")
    if eng.steady_state_recompiles():
        fail(f"{eng.steady_state_recompiles()} steady-state re-captures")
    reqs = img_reqs + spike_reqs
    sigs = {("spikes" if r.spikes is not None else "image",
             r.num_steps or CONFIG.num_steps) for r in reqs}
    if (eng.admit_captures != len(sigs) or set(eng._admit_graphs) != sigs
            or eng.admit_replays != len(reqs)):
        fail(f"admission: {eng.admit_captures} captures, "
             f"{eng.admit_replays} replays for {len(reqs)} requests of "
             f"{len(sigs)} (kind, T) signatures")
    launches = eager + per * eng.graph_replays
    for r, req in zip(results, img_reqs + spike_reqs):
        T = req.num_steps or CONFIG.num_steps
        if r.disposition != "ok" or r.steps != T:
            fail(f"request {r.request_id}: {r.disposition} {r.fault}")
        if r.prediction not in (0, 1) or not r.events_per_layer[0] > 0:
            fail(f"request {r.request_id}: prediction {r.prediction}, "
                 f"events {r.events_per_layer}")
        if not (np.isfinite(r.energy_pj) and r.energy_pj > 0):
            fail(f"request {r.request_id}: energy {r.energy_pj}")
    events = float(sum(r.events_per_layer.sum() for r in results))
    tb = eng.tick_breakdown()
    print(f"main path (graph): {len(results)} requests ok in {wall:.3f} s "
          f"over {eng.dispatched_ticks} ticks = {eng.graph_replays} graph "
          f"replays x {per} snn_chunk launch + {eager} warm-up launch(es) | "
          f"captures {eng.graph_captures}, steady-state re-captures "
          f"{eng.steady_state_recompiles()} | {len(results) / wall:.1f} req/s "
          f"| {events / wall:.0f} events/s | "
          f"{wall / eng.dispatched_ticks * 1e3:.3f} ms/tick | on {card}")
    print(f"main path (graph): tick_breakdown {json.dumps(tb)}")
    print(f"main path (graph): admission through {eng.admit_replays} graph "
          f"replays of {eng.admit_captures} captures, one per (kind, T) "
          f"signature ({len(sigs)}) | on {card}")
    where_host_time_goes("graph", eng, wall)
    # the same requests again on the same engine: every signature is
    # captured, so admission is replays only
    t_again = time.perf_counter()
    ticks1 = eng.dispatched_ticks
    again, wall2, _ = serve(eng)
    ms_tick_captured = wall2 / (eng.dispatched_ticks - ticks1) * 1e3
    if eng.admit_captures != len(sigs) or eng.steady_state_recompiles():
        fail(f"admission re-captured on a second serve: "
             f"{eng.admit_captures} captures for {len(sigs)} signatures, "
             f"{eng.steady_state_recompiles()} re-captures")
    if eng.admit_replays != 2 * len(reqs):
        fail(f"admission: {eng.admit_replays} replays over two serves of "
             f"{len(reqs)}")
    where_host_time_goes("graph, captured", eng, wall2, since=t_again)

    base = engine("fused", cuda_graph=False)
    base_results, base_wall, base_launches = serve(base)
    check_no_retries("main path (graph)", eng)
    check_no_retries("main path (eager)", base)
    print(f"main path (eager): {len(base_results)} requests in "
          f"{base_wall:.3f} s over {base.dispatched_ticks} ticks, "
          f"{base_launches} snn_chunk launches | "
          f"{len(base_results) / base_wall:.1f} req/s | "
          f"{base_wall / base.dispatched_ticks * 1e3:.3f} ms/tick | on {card}")
    print(f"main path (eager): tick_breakdown "
          f"{json.dumps(base.tick_breakdown())}")
    if base.admit_captures or base.admit_replays:
        fail("the eager engine admitted through graphs")
    where_host_time_goes("eager", base, base_wall)
    spread = {"graph": [], "graph, captured": [], "eager": []}
    for name in ("eager", "graph", "graph", "eager", "eager", "graph"):
        e = engine("fused", cuda_graph=name == "graph")
        w = serve(e)[1]
        spread[name].append(round(w / e.dispatched_ticks * 1e3, 3))
        if name == "graph":  # the same engine again, admission captured
            ticks = e.dispatched_ticks
            w = serve(e)[1]
            spread["graph, captured"].append(
                round(w / (e.dispatched_ticks - ticks) * 1e3, 3))
    print(f"main path: ms/tick, three more runs each, in turns (a graph "
          f"engine's first serve captures its admission graphs, its second "
          f"replays them): {json.dumps(spread)} | on {card}")

    def fields(r):  # every field but the clocks and the request id
        return (r.prediction, r.steps, r.spike_rate, r.energy_pj,
                r.spike_counts.tolist(), r.events_per_layer.tolist(),
                r.disposition, r.fault, r.deadline_s, r.deadline_missed)

    if [fields(r) for r in results] != [fields(r) for r in base_results]:
        fail("the graph engine differs from the eager engine")
    print(f"main path: the graph engine equals the eager engine on all "
          f"{len(results)} requests")
    n_img = len(img_reqs)
    if ([fields(r) for r in again[n_img:]]
            != [fields(r) for r in results[n_img:]]):
        fail("the second serve differs from the first on spike requests")
    fused = [fields(r) for r in results[len(img_reqs):]]
    plain = [fields(r) for r in engine("fused_ref").run(spike_reqs)]
    if fused != plain:
        bad = [i for i, (a, b) in enumerate(zip(fused, plain)) if a != b]
        fail(f"engine on the plain version differs on spike requests {bad}")
    print(f"main path: the plain-version engine matches the kernel engine "
          f"on all {len(plain)} spike requests")
    ref = [fields(r) for r in engine("torch").run(spike_reqs)]
    same = sum(a == b for a, b in zip(fused, ref))
    same_pred = sum(a[0] == b[0] for a, b in zip(fused, ref))
    print(f"main path: backend='torch' agrees on {same}/{len(ref)} spike "
          f"requests in every field, {same_pred}/{len(ref)} in prediction "
          f"(its layer-0 sums run in another order; not gated)")

    reads, allocs = steady_tick(torch, engine("fused"), img_reqs[:SLOTS])
    print(f"main path: one steady tick passed set_sync_debug_mode('error') "
          f"with {reads} stats read and {allocs} device allocations")
    n = steady_admission(torch, eng, [img_reqs[0], spike_reqs[0]])
    print(f"main path: {n} steady admissions (image, spikes), each a replay "
          f"and its tick, passed set_sync_debug_mode('error') with 0 device "
          f"allocations")
    for kind, T in (("image", CONFIG.num_steps),
                    ("spikes", spike_reqs[0].num_steps)):
        # the engine is idle: a replay rewrites the last admitted slot,
        # which no request holds
        a = dispatch_attribution(eng._admit_graphs[(kind, T)]["graph"].replay,
                                 device=dev, iters=21)
        print(f"dispatch_attribution[admission replay, {kind}, T = {T}]: "
              f"host enqueue {a['host_enqueue_us']:.1f} us | device "
              f"(CUDA events) {a['device_us']:.1f} us | on {card}")
    caps = sorted(x.t1 - x.t0 for x in eng.trace.spans()
                  if x.name == "admit_capture")
    print(f"main path: {len(caps)} admission graph captures took "
          f"{sum(caps) * 1e3:.1f} ms, median {caps[len(caps) // 2] * 1e3:.2f} "
          f"ms, longest {caps[-1] * 1e3:.2f} ms | on {card}")

    twin_args = eng.staged_chunk_args(
        [np.asarray(r.spikes) for r in spike_reqs[:SLOTS]])
    twin = eng.chunk_for_timing()
    att = {
        "graph": dispatch_attribution(graph_of(torch, twin, *twin_args),
                                      device=dev, iters=21),
        "eager": dispatch_attribution(twin, *twin_args, device=dev, iters=21),
    }
    for name, a in att.items():
        print(f"dispatch_attribution[{name}]: host enqueue "
              f"{a['host_enqueue_us']:.1f} us | device wait "
              f"{a['device_wait_us']:.1f} us | total {a['total_us']:.1f} us "
              f"| device (CUDA events) {a['device_us']:.1f} us | "
              f"{a['verdict']} | on {card}")
    busy = {name: profile_main(torch, engine("fused", cuda_graph=graphed),
                               img_reqs + spike_reqs, card, name)
            for name, graphed in (("graph", True), ("eager", False))}
    rate_nj = statistics.mean(r.energy_pj for r in results[:len(img_reqs)]) / 1e3
    return {"launches": launches, "wall_s": wall,
            "ticks": eng.dispatched_ticks, "busy": busy,
            "ms_tick_captured": ms_tick_captured,
            "rate_coded": {"ms_tick": wall / eng.dispatched_ticks * 1e3,
                           "req_s": len(results) / wall,
                           "events_s": events / wall, "energy_nj": rate_nj}}


def profile_main(torch, eng, reqs, card, name):
    """The main path once more under torch.profiler: device time by
    kernel and the device's busy share of the traced wall time (the
    profiler slows the host side, so this wall is longer).  For a graph
    engine, also the profiler's count of ``snn_chunk_kernel`` records, a
    second witness of the launches (one a replay, one a warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_us = device_time_us(torch, prof)
    busy_ms = sum(device_us.values()) / 1e3
    if busy_ms == 0:
        print(f"profile[{name}]: the profiler recorded no device time: not "
              f"measured")
        return None
    records = sum(ev.count for ev in prof.key_averages()
                  if "snn_chunk_kernel" in ev.key
                  and ev.device_type == torch.autograd.DeviceType.CUDA)
    expected = (eng.graph_replays + eng.graph_captures if eng.graphed
                else eng.dispatched_ticks)
    # a profiler run can lose a record or two (PERF.md, section 7)
    if not expected - 2 <= records <= expected:
        fail(f"profile[{name}]: {records} snn_chunk_kernel records for "
             f"{expected} launches")
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
    print(f"profile[{name}]: traced wall {wall_ms:.1f} ms over "
          f"{eng.dispatched_ticks} ticks | device busy {busy_ms:.1f} ms "
          f"({busy_ms / wall_ms:.1%}) | snn_chunk_kernel records {records} "
          f"of {expected} launches | on {card}")
    for kname, us in top:
        print(f"profile[{name}]:   {us / 1e3:8.3f} ms  {kname[:90]}")
    return busy_ms / wall_ms


def fault_fields(r):
    """Every field of a result but the clocks, the deadline verdict and
    the request id: what two runs of the same requests must agree on."""
    return (r.prediction, r.steps, r.spike_rate, r.energy_pj,
            r.spike_counts.tolist(), r.events_per_layer.tolist(),
            r.disposition, r.fault, r.parked)


def check_no_retries(name, eng):
    """A run without injected faults: no retry and no demotion."""
    snap = eng.metrics_snapshot()
    retries = snap["engine.faults.chunk_retries"]["value"]
    demoted = snap["engine.faults.backend_demoted"]["value"]
    if retries or demoted:
        fail(f"{name}: {retries} chunk retries, {demoted} demotions without "
             f"an injected fault")


def check_clean(name, eng):
    """A graphed run without injected faults: no retry, no demotion, no
    steady-state re-capture, and one kernel launch a replay for every
    dispatched tick."""
    check_no_retries(name, eng)
    check_graph(name, eng)


def check_graph(name, eng):
    if eng.steady_state_recompiles():
        fail(f"{name}: {eng.steady_state_recompiles()} steady-state "
             f"re-captures")
    if eng.admit_captures < 1 or eng.admit_replays < eng.admit_captures:
        fail(f"{name}: admission not through graphs: {eng.admit_captures} "
             f"captures, {eng.admit_replays} replays")
    per = eng.graph_launches_per_replay
    if not eng.graphed or per != 1 or per * eng.graph_replays != (
            eng.dispatched_ticks):
        fail(f"{name}: graphed {eng.graphed}, {per} snn_chunk launch(es) a "
             f"replay x {eng.graph_replays} replays != "
             f"{eng.dispatched_ticks} dispatched ticks")


def steady_poll(torch, eng, name):
    """Poll until the next tick is steady (no admission, resume or park
    pending, no window finishing, one chunk in flight), then run that
    tick under ``set_sync_debug_mode("error")``, failing on any implicit
    synchronisation (the tick's one wait, the stats event in ``_retire``,
    is an explicit ``Event.synchronize`` and is not exempted), on more or
    fewer than one host read (``_fetch``) and on any device allocation."""
    def steady():
        resident = [s for s in range(eng.S) if eng._slot_req[s] is not None]
        return (resident and not eng._queue and not eng._parked
                and not eng._preempt_parked
                and len(eng._inflight) == eng.pipeline_depth
                and all(eng._slot_total[s] - eng._slot_done[s] > eng.Tc
                        for s in resident))

    results = []
    while not steady():
        if eng.idle():
            fail(f"{name}: no steady tick before the engine went idle")
        results += eng.poll()
    torch.cuda.synchronize()
    fetches = []
    real_fetch = eng._fetch
    eng._fetch = lambda host, ready: (fetches.append(1),
                                      real_fetch(host, ready))[1]
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    torch.cuda.set_sync_debug_mode("error")
    try:
        results += eng.poll()
    except RuntimeError as err:
        fail(f"{name}: a steady tick synchronised implicitly: {err}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
        del eng._fetch
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - allocs
    if len(fetches) != 1 or allocs != 0:
        fail(f"{name}: steady tick made {len(fetches)} stats reads and "
             f"{allocs} device allocations")
    return results, len(fetches), allocs


def phase_faults(torch, dev, params_np, card):
    """Phase 9: the fault-tolerance plane, preemption and crash-safe state
    on the graph engine at full width, spike requests only."""
    import shutil
    import warnings

    import numpy as np

    from repro_torch.configs.collision_snn import CONFIG
    from repro_torch.core import snn
    from repro_torch.faults import (AdmissionPolicy, Fault, FaultInjector,
                                    FaultSchedule, RetryPolicy,
                                    corrupt_checkpoint)
    from repro_torch.serving.snn_engine import SNNStreamEngine, StreamRequest

    params = snn.params_from_numpy(params_np, dev)
    K, T = CONFIG.layer_sizes[0], CONFIG.num_steps
    rng = np.random.default_rng(SEED + 9)

    def trains(n, steps=None):
        out = []
        for i in range(n):
            t = int(steps[i]) if steps is not None else T
            out.append((rng.random((t, K)) < rng.uniform(0.05, 0.4))
                       .astype(np.float32))
        return out

    def engine(backend="fused", **kw):
        return SNNStreamEngine(params, CONFIG, num_slots=SLOTS,
                               chunk_steps=TC, backend=backend, device=dev,
                               **kw)

    def reqs(xs, **kw):
        return [StreamRequest(spikes=x, num_steps=x.shape[0], **kw)
                for x in xs]

    def p50_us(eng, key):
        return eng.metrics_snapshot()[key]["p50"] * 1e6

    # chaos: two NaN membranes, two corrupt rings, two transient
    # exceptions, at seeded ticks and slots
    chaos_x = trains(48, rng.integers(10, T + 1, 48))
    clean_eng = engine()
    clean = {r.request_id: r for r in clean_eng.run(reqs(chaos_x))}
    check_clean("chaos, fault-free run", clean_eng)
    horizon = clean_eng.dispatched_ticks - 4
    kinds = ["nan_membrane"] * 2 + ["corrupt_ring"] * 2 + ["chunk_exception"] * 2
    schedule = FaultSchedule(faults=tuple(sorted((
        Fault(tick=int(rng.integers(1, horizon)), kind=k,
              slot=int(rng.integers(SLOTS)), layer=int(rng.integers(2)))
        for k in kinds), key=lambda f: f.tick)), seed=SEED + 9)
    inj = FaultInjector(schedule)
    eng = engine(injector=inj,
                 retry=RetryPolicy(max_retries=8, backoff_s=0.0))
    results = eng.run(reqs(chaos_x))
    hit = [rec for rec in inj.applied
           if rec["kind"] in ("nan_membrane", "corrupt_ring")]
    faulted = {rec["rid"] for rec in hit}
    quarantined = {r.request_id for r in results
                   if r.disposition == "quarantined"}
    snap = eng.metrics_snapshot()
    if len(hit) != 4 or quarantined != faulted:
        fail(f"chaos: {len(hit)} state/ring faults applied to {faulted}, "
             f"quarantined {quarantined}")
    if snap["engine.requests.quarantined"]["value"] != len(faulted):
        fail("chaos: the quarantine counter disagrees with the results")
    bad = [r.request_id for r in results if r.request_id not in faulted
           and fault_fields(r) != fault_fields(clean[r.request_id])]
    if bad:
        fail(f"chaos: requests {bad} differ from the fault-free graph run")
    retries = snap["engine.faults.chunk_retries"]["value"]
    if inj.raised != 2 or retries != inj.raised:
        fail(f"chaos: {inj.raised} injected raises, {retries} retries")
    if snap["engine.faults.backend_demoted"]["value"]:
        fail("chaos: a transient fault demoted the engine")
    check_graph("chaos", eng)
    print(f"faults[chaos]: 48 requests, {len(inj.applied)} faults applied "
          f"({len(hit)} state/ring at ticks "
          f"{[rec['tick'] for rec in hit]}), quarantined "
          f"{sorted(quarantined)} = the faulted requests, the other "
          f"{len(results) - len(quarantined)} equal the fault-free graph "
          f"run bit for bit | retries {int(retries)} = injected raises | "
          f"{eng.graph_replays} replays = {eng.dispatched_ticks} ticks, "
          f"re-captures 0 | on {card}")

    # demotion: a persistent fused-only exception from the first tick
    inj = FaultInjector(FaultSchedule(faults=(Fault(
        tick=0, kind="chunk_exception", times=10**6, only_backend="fused"),)))
    eng = engine(injector=inj, retry=RetryPolicy(max_retries=1, backoff_s=0.0))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        demoted = eng.run(reqs(chaos_x))
    warns = [w for w in caught if issubclass(w.category, RuntimeWarning)
             and "demoting backend fused -> torch" in str(w.message)]
    snap = eng.metrics_snapshot()
    if (len(warns) != 1 or snap["engine.faults.backend_demoted"]["value"] != 1
            or eng.backend != "torch" or eng.graphed or eng._graph is not None):
        fail(f"demotion: {len(warns)} warnings, demoted "
             f"{snap['engine.faults.backend_demoted']['value']}, backend "
             f"{eng.backend}, graphed {eng.graphed}")
    plain_eng = engine("torch")
    plain = plain_eng.run(reqs(chaos_x))
    if [fault_fields(r) for r in demoted] != [fault_fields(r) for r in plain]:
        fail("demotion: the demoted engine differs from the plain chunk")
    same = [(r.prediction, r.spike_counts.tolist(), r.events_per_layer.tolist())
            == (c.prediction, c.spike_counts.tolist(),
                c.events_per_layer.tolist())
            for r, c in zip(demoted, (clean[i] for i in range(48)))]
    if not all(same):
        fail(f"demotion: spike counts, events or prediction differ from the "
             f"fault-free graph run on requests "
             f"{[i for i, ok in enumerate(same) if not ok]}")
    print(f"faults[demotion]: one RuntimeWarning, backend_demoted 1, backend "
          f"{eng.backend}, graphed {eng.graphed}; 48 results equal the plain "
          f"chunk's in every field and the fault-free graph run's in spike "
          f"counts, events and prediction | on {card}")

    # admission: one burst, the bounded queue sheds and parks; the same
    # burst through the port on the CPU sheds and parks the same
    def burst(eng):
        xs = trains(48)
        for i, x in enumerate(xs):
            eng.submit(StreamRequest(spikes=x, priority=int(i % 3 == 0)))
        res = eng.drain()
        return ((sum(r.disposition == "shed" for r in res),
                 sum(r.parked for r in res),
                 sum(r.disposition == "ok" for r in res)), eng.shed_rate())

    eng = engine(admission=AdmissionPolicy(max_queue_depth=8))
    card_counts, shed_rate = burst(eng)
    check_clean("admission", eng)
    cpu_eng = SNNStreamEngine(
        snn.params_from_numpy(params_np, "cpu"), CONFIG, num_slots=SLOTS,
        chunk_steps=TC, device="cpu",
        admission=AdmissionPolicy(max_queue_depth=8))
    cpu_counts, _ = burst(cpu_eng)
    if card_counts != cpu_counts or card_counts[0] == 0:
        fail(f"admission: (shed, parked, ok) {card_counts} on the card, "
             f"{cpu_counts} on the CPU")
    print(f"faults[admission]: burst of 48, max_queue_depth 8: shed "
          f"{card_counts[0]}, parked then served {card_counts[1]}, ok "
          f"{card_counts[2]} (the CPU: {cpu_counts}) | shed_rate() "
          f"{shed_rate:.4f} | on {card}")

    # preemption: 8 loose windows, then 4 tight ones of one chunk each
    loose, tight = trains(8), trains(4, [TC] * 4)

    def preempt_run(eng):
        for r in reqs(loose, deadline_s=1e4):
            eng.submit(r)
        res = eng.poll()
        for r in reqs(tight, deadline_s=5.0):
            eng.submit(r)
        return res

    def by_rid(results):
        return {r.request_id: fault_fields(r) for r in results}

    base = engine()
    base_res = by_rid(preempt_run(base) + base.drain())
    check_clean("preemption, without preempt", base)
    eng = engine(preempt=True)
    res = preempt_run(eng)
    res2, reads, allocs = steady_poll(torch, eng, "preemption")
    res = by_rid(res + res2 + eng.drain())
    snap = eng.metrics_snapshot()
    parks = snap["engine.preempt.parked"]["value"]
    resumed = snap["engine.preempt.resumed"]["value"]
    if parks < 1 or resumed != parks:
        fail(f"preemption: {parks} parks, {resumed} resumes")
    if res != base_res or sorted(res) != list(range(12)):
        fail("preemption: results differ from the run without preempt")
    check_clean("preemption", eng)
    print(f"faults[preemption]: {int(parks)} park(s), {int(resumed)} "
          f"resume(s); 12 results equal the run without preempt bit for bit "
          f"| steady tick after the resume: {reads} stats read, {allocs} "
          f"device allocations, set_sync_debug_mode('error') | re-captures 0 "
          f"| park_s p50 {p50_us(eng, 'engine.preempt.park_s'):.1f} us, "
          f"restore_s p50 {p50_us(eng, 'engine.preempt.restore_s'):.1f} us "
          f"| on {card}")

    # snapshot mid-run (a queue, one preempt-parked window), restore into
    # an engine that has already captured its graph, drain
    snap_root = ROOT / "build" / "smoke_snapshots"
    shutil.rmtree(snap_root, ignore_errors=True)
    extra = trains(3)

    def snap_run(eng, path=None):
        res = preempt_run(eng)
        for r in reqs(extra, deadline_s=2e4):
            eng.submit(r)
        res += eng.poll()  # parks a window; the queue holds the rest
        if path is not None:
            if eng.queue_depth() == 0 or eng.preempt_parked_depth() != 1:
                fail(f"snapshot: queue {eng.queue_depth()}, preempt-parked "
                     f"{eng.preempt_parked_depth()} at the snapshot")
            eng.snapshot(str(path))
        return res

    whole = engine(preempt=True)
    want = by_rid(snap_run(whole) + whole.drain())
    eng1 = engine(preempt=True)
    early = snap_run(eng1, snap_root / "mid")
    queued = eng1.queue_depth()
    eng2 = engine(preempt=True)
    eng2.run(reqs(trains(1)))  # captures its graph
    captures = eng2.graph_captures
    eng2.restore(str(snap_root / "mid"))
    if by_rid(early + eng2.drain()) != want:
        fail("snapshot: the restored engine differs from the uninterrupted "
             "run")
    if eng2.graph_captures != captures:
        fail(f"snapshot: restore re-captured ({captures} -> "
             f"{eng2.graph_captures})")
    check_clean("snapshot, restored engine", eng2)
    nbytes = sum(p.stat().st_size for p in (snap_root / "mid").rglob("*")
                 if p.is_file())
    save_ms = eng1.metrics_snapshot()["engine.snapshot.save_s"]["sum"] * 1e3
    load_ms = eng2.metrics_snapshot()["engine.snapshot.restore_s"]["sum"] * 1e3

    # a keep-N rotation whose newest snapshot is corrupt falls back
    rot = snap_root / "rotation"
    eng3 = engine()
    for r in reqs(trains(12)):
        eng3.submit(r)
    first = eng3.poll()
    eng3.snapshot_auto(str(rot))
    rest = eng3.poll()
    eng3.snapshot_auto(str(rot))
    whole3 = by_rid(first + rest + eng3.drain())
    corrupt_checkpoint(str(rot))
    eng4 = engine()
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        restored = eng4.restore_latest_snapshot(str(rot))
    fallback = eng4.metrics_snapshot()[
        "engine.faults.checkpoint_fallback"]["value"]
    if (restored is None or not restored.endswith("snap_000001")
            or fallback != 1):
        fail(f"snapshot: corrupt newest snapshot, restored {restored}, "
             f"checkpoint_fallback {fallback}")
    if by_rid(first + eng4.drain()) != whole3:
        fail("snapshot: the fallback restore differs from the run")
    check_clean("snapshot, fallback engine", eng4)
    shutil.rmtree(snap_root, ignore_errors=True)
    print(f"faults[snapshot]: {len(want)} requests, snapshot with {queued} "
          f"queued and 1 preempt-parked window, restored into an engine that "
          f"had captured (captures {captures} -> {eng2.graph_captures}): "
          f"results equal the uninterrupted run bit for bit | snapshot "
          f"{save_ms:.2f} ms, {nbytes} bytes on disk, restore {load_ms:.2f} "
          f"ms | corrupt newest of 2 rotated: fell back to "
          f"{Path(restored).name}, checkpoint_fallback 1, results equal the "
          f"run | on {card}")


def train_config():
    """The paper's network on the reference trainer's DVS workload:
    64x64 signed DVS -> 4096-512-2, T = 25."""
    from repro_torch.sparse_train.trainer import EventTrainConfig

    return EventTrainConfig(image_hw=64, hidden=512, num_steps=25,
                            polarity_mode="signed")


def aer_bound(addrs, values, weights):
    """Least time for one ``aer_spike_matmul_batched`` call on an H100 SXM:
    the larger of the bytes it must move (the W rows this call's live
    events touch, the live events' addresses and values, the output) over
    the memory rate and its multiply-adds over the float32 rate (the
    int32 rate for int16 weights)."""
    import torch

    K, N = weights.shape
    live = (values != 0) & (addrs >= 0) & (addrs < K)
    n_live = int(live.sum())
    rows = int(torch.unique(addrs[live]).numel())
    nbytes = (rows * N * weights.element_size() + n_live * 8
              + addrs.shape[0] * N * 4)
    flops = 2 * n_live * N
    rate = INT32_OPS if weights.dtype == torch.int16 else F32_FLOPS
    return bound_of(nbytes, flops, rate), {
        "events": n_live, "distinct_rows": rows, "bytes": nbytes,
        "flops": flops}


def phase_aer_kernel(torch, dev, params_np, card):
    """Phase 5: the aer kernel against its plain version at the training
    shapes, over a DVS batch rendered on the card, and the single stream
    (``aer_spike_matmul``, int16) on one stream of the dense step."""
    import numpy as np
    import torch.nn.functional as F

    from repro_torch.core import quant
    from repro_torch.events import runtime
    from repro_torch.kernels import aer_matmul as aer_mod
    from repro_torch.kernels import ops
    from repro_torch.sparse_train.trainer import dvs_batches

    tcfg = train_config()
    planes = next(dvs_batches(SEED + 4, TRAIN_BATCH, tcfg, device=dev))["spikes"]
    rng = np.random.default_rng(SEED + 4)
    w0 = torch.from_numpy(params_np["layer0"]["w"]).to(dev)
    w1 = torch.from_numpy(params_np["layer1"]["w"]).to(dev)
    hidden = torch.from_numpy((rng.random((TRAIN_BATCH, w1.shape[0])) < 0.15)
                              .astype(np.float32)).to(dev)
    cases = {
        "layer0_dense_t0": (planes[:, 0], w0),
        "layer0_sparse_t24": (planes[:, tcfg.num_steps - 1], w0),
        "layer1": (hidden, w1),
    }
    fn, ref_fn = aer_mod.aer_spike_matmul_batched, aer_mod.aer_spike_matmul_batched_ref
    live = (planes != 0).sum((0, 2)).tolist()  # layer-0 events a step
    print(f"aer[batch]: live layer-0 events a step (B = {TRAIN_BATCH}, T = "
          f"{tcfg.num_steps}): {live}")

    def plain_ms(call):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    def record(name, call, plain, library, addrs, values, w, err):
        geo = aer_mod.plan(*addrs.shape, *w.shape, w.dtype == torch.int16)
        (bound_by, bound_ms), work = aer_bound(addrs, values, w)
        rec = {"ms": kernel_ms(call), "call_ms": cuda_ms(call),
               "alone_ms": device_ms(call, only=f"aer_{geo.variant}_kernel"),
               "library_ms": kernel_ms(library),
               "plain_ms": plain_ms(plain),  # host clock: it syncs once a call
               "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err,
               "variant": geo.variant}
        print(f"aer[{name}]: B={addrs.shape[0]} E={addrs.shape[1]} "
              f"K={w.shape[0]} N={w.shape[1]} {w.dtype} | plan: {geo} | "
              f"kernel {rec['ms']:.4f} ms device a call (aer_{geo.variant}_kernel "
              f"alone {rec['alone_ms'] or 0:.4f} ms; per call {rec['call_ms']:.4f}"
              f" ms) | plain {rec['plain_ms']:.1f} ms (host clock) | "
              f"embedding_bag {rec['library_ms']:.4f} ms | bound "
              f"{bound_ms:.5f} ms ({bound_by}; {work}) | on {card}")
        return rec

    out = {}
    for name, (plane, w) in cases.items():
        addrs, values, _ = runtime.step_events(plane, plane.shape[-1])
        got, ref = fn(addrs, values, w), ref_fn(addrs, values, w)
        wq = quant.quantize(w)
        vq = values.to(torch.int32)
        got_q, ref_q = fn(addrs, vq, wq), ref_fn(addrs, vq, wq)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        if not torch.equal(got, ref):
            fail(f"aer {name}: float32 kernel differs from its plain version "
                 f"by {err}")
        if not torch.equal(got_q, ref_q):
            fail(f"aer {name}: int16 kernel differs from its plain version")
        lib = F.embedding_bag(addrs, w, per_sample_weights=values, mode="sum")
        out[name] = record(
            name, lambda: fn(addrs, values, w), lambda: ref_fn(addrs, values, w),
            lambda: F.embedding_bag(addrs, w, per_sample_weights=values,
                                    mode="sum"),
            addrs, values, w, err)
        print(f"aer[{name}]: int16 ({aer_mod.plan(*addrs.shape, *w.shape, True).variant}"
              f") exact | embedding_bag float32 max|d| "
              f"{float((lib - got).abs().max()):.2g} (another sum order; not gated)")

    # the single stream: stream 0 of the dense step, int16 codes
    addrs, values, _ = runtime.step_events(planes[:1, 0], planes.shape[-1])
    a1, v1, wq0 = addrs[0], values[0].to(torch.int8), quant.quantize(w0)
    got = ops.aer_spike_matmul(a1, v1, wq0)
    if not torch.equal(got, aer_mod.aer_spike_matmul_ref(a1, v1, wq0)):
        fail("aer single_int16: kernel differs from its plain version")
    vd, wd = v1.double()[None], wq0.double()
    out["single_int16"] = record(
        "single_int16", lambda: ops.aer_spike_matmul(a1, v1, wq0),
        lambda: aer_mod.aer_spike_matmul_ref(a1, v1, wq0),
        lambda: F.embedding_bag(a1[None], wd, per_sample_weights=vd, mode="sum"),
        a1[None], v1[None], wq0, 0.0)
    return out


def _grads(torch, trainer, params, batch):
    from repro_torch.tree import tree_leaves, tree_map

    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = trainer.model.loss(live, batch)
    return [loss.detach()] + list(torch.autograd.grad(loss, tree_leaves(live)))


def train_windows(torch, tr, batches, dev):
    """``TRAIN_STEPS`` steps of ``tr`` from the seed in ``TRAIN_WINDOW``-step
    log windows.  Returns each window's state (params and Adam state,
    copied) and metrics, the ms a step of ``run`` (the batches rendered on
    the card inside the loop; each window ends in its one device read)
    and the final state."""
    from repro_torch.tree import tree_leaves

    state = tr.init_state(SEED)
    it = batches()
    windows, run_s = [], 0.0
    for _ in range(TRAIN_STEPS // TRAIN_WINDOW):
        t0 = time.perf_counter()
        state, metrics = tr.run(state, it, TRAIN_WINDOW,
                                log_every=TRAIN_WINDOW, log_fn=lambda _: None)
        run_s += time.perf_counter() - t0
        windows.append(([x.clone() for x in
                         tree_leaves((state.params, state.opt_state))],
                        metrics))
    torch.cuda.synchronize(dev)
    return windows, run_s / TRAIN_STEPS * 1e3, state


def step_ms(torch, tr, state, batches):
    """ms a step of ``step_fn`` alone over pre-rendered batches (host clock
    around the steps and one synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        state, _ = tr.step_fn(state, b)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / len(batches) * 1e3, state


def phase_train(torch, dev, card):
    """Phase 6: event-driven training at full width through the kernel,
    the default step one CUDA graph replay, against the eager step."""
    from unittest import mock

    import numpy as np

    from repro_torch.analysis import RecompileDetector
    from repro_torch.kernels import aer_matmul as aer_mod
    from repro_torch.kernels import snn_chunk as chunk_mod
    from repro_torch.sparse_train.trainer import EventTrainer, dvs_batches
    from repro_torch.train.loop import StaticStep

    tcfg = train_config()
    aer_fn = aer_mod.aer_spike_matmul_batched
    L = tcfg.snn_config().num_layers
    per_step = tcfg.num_steps * L

    def trainer(jit=True):
        return EventTrainer(tcfg, use_kernel=True, device=dev, seed=SEED,
                            jit=jit)

    def batches():
        return dvs_batches(SEED, TRAIN_BATCH, tcfg, device=dev)

    warm = trainer()  # allocator, the kernels' build, a first capture
    warm.run(warm.init_state(SEED), batches(), 1, log_fn=lambda _: None)
    torch.cuda.synchronize()

    # the main path: the graphed trainer, counts from 0, read right after
    tr = trainer()
    if not isinstance(tr.step_fn, StaticStep) or not tr.step_fn.donate:
        fail("EventTrainer's default step is not the donated static step")
    eval_batch = next(dvs_batches(SEED + 9, TRAIN_BATCH, tcfg, device=dev))
    torch.cuda.synchronize()
    aer_fn.launches = aer_fn.captured = 0
    chunk_mod.snn_chunk.launches = 0
    with RecompileDetector() as det:
        det.track("train_step", tr.step_fn, allowed=1)  # the cold start
        graph_windows, graph_ms, state = train_windows(torch, tr, batches, dev)
    acc = float(tr.evaluate(state.params, eval_batch)["accuracy"])
    eager_launches, captured = aer_fn.launches, aer_fn.captured
    chunk_launches = chunk_mod.snn_chunk.launches
    step = tr.step_fn
    if step.captures != 1 or det.cache_growth("train_step") != 1 \
            or det.unexpected():
        fail(f"the graphed step captured {step.captures} time(s) "
             f"(re-captures: {det.unexpected()})")
    if captured != per_step or step.replays != TRAIN_STEPS:
        fail(f"{captured} aer launches captured, {step.replays} replays: "
             f"want T x L = {per_step} and {TRAIN_STEPS}")
    if eager_launches != per_step:
        fail(f"{eager_launches} eager aer launches: want the one warm-up "
             f"step's T x L = {per_step}")
    if chunk_launches != 1:
        fail(f"evaluate launched snn_chunk {chunk_launches} times, want 1")
    replays = step.replays
    launches = eager_launches + captured * replays
    for leaves, metrics in graph_windows:
        if not (np.isfinite(metrics["loss"]) and
                all(bool(torch.isfinite(x).all()) for x in leaves)):
            fail(f"graphed run: loss {metrics['loss']} or state not finite")

    # a steady replay reads the host nowhere
    it = batches()
    steady = [next(it) for _ in range(2 * TRAIN_WINDOW)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, _ = tr.step_fn(state, steady[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graph_step_ms, state = step_ms(torch, tr, state, steady)

    # the same run twice more: graphed again, and eager
    again, _, _ = train_windows(torch, trainer(), batches, dev)
    eager_tr = trainer(jit=False)
    eager_windows, eager_ms, eager_state = train_windows(
        torch, eager_tr, batches, dev)
    eager_step_ms, _ = step_ms(torch, eager_tr, eager_state, steady)

    def differ(a, b):
        return [i for i, ((la, ma), (lb, mb)) in enumerate(zip(a, b))
                if ma != mb or not all(torch.equal(x, y)
                                       for x, y in zip(la, lb))]

    if differ(graph_windows, again):
        fail(f"two graphed runs from one seed differ at windows "
             f"{differ(graph_windows, again)}")
    if differ(graph_windows, eager_windows):
        fail(f"the graphed and the eager run differ at windows "
             f"{differ(graph_windows, eager_windows)}")
    last = graph_windows[-1][1]
    n_win = len(graph_windows)
    print(f"train: {tcfg.input_size}-{tcfg.hidden}-2 T={tcfg.num_steps} "
          f"B={TRAIN_BATCH}, {TRAIN_STEPS} steps in {n_win} log windows of "
          f"{TRAIN_WINDOW} | final loss {last['loss']:.4f}, events l0/l1 "
          f"{last['events_l0']:.0f}/{last['events_l1']:.0f}, eval accuracy "
          f"{acc:.3f} | graphed, graphed again and eager runs bit-identical "
          f"at all {n_win} windows (params, Adam state, {len(last)} metrics) "
          f"| on {card}")
    print(f"train[graph]: {graph_ms:.2f} ms/step in run() (batches rendered "
          f"on the card in the loop), {graph_step_ms:.2f} ms/step of the step "
          f"alone | captures {step.captures}, re-captures 0 "
          f"(RecompileDetector clean), replays {replays} x {captured} "
          f"captured aer launches = {captured * replays} (= steps x T x "
          f"L) + {eager_launches} warm-up launches | snn_chunk launches "
          f"{chunk_launches} (evaluate) | a steady replay passes "
          f"set_sync_debug_mode('error') | on {card}")
    print(f"train[eager]: {eager_ms:.2f} ms/step in run(), {eager_step_ms:.2f} "
          f"ms/step of the step alone | graph speed-up "
          f"{eager_ms / graph_ms:.2f}x in run(), "
          f"{eager_step_ms / graph_step_ms:.2f}x the step alone | on {card}")

    tr = trainer(jit=False)
    params = tr.init_state(SEED).params
    batch = next(batches())
    kern = _grads(torch, tr, params, batch)
    with mock.patch.object(aer_mod, "aer_spike_matmul_batched",
                           aer_mod.aer_spike_matmul_batched_ref):
        t0 = time.perf_counter()
        plain = _grads(torch, tr, params, batch)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
    if not all(torch.equal(x, y) for x, y in zip(kern, plain)):
        bad = [i for i, (x, y) in enumerate(zip(kern, plain))
               if not torch.equal(x, y)]
        fail(f"the kernel step and the plain-version step differ at {bad}")
    print(f"train: one step's loss and all {len(kern) - 1} gradients "
          f"bit-equal on the plain version ({plain_s:.1f} s) and the kernel")
    busy = {name: profile_train(torch, trainer(jit), batches, card, name,
                                alone)
            for name, jit, alone in (("graph", True, False),
                                     ("graph, step alone", True, True),
                                     ("eager", False, False))}
    return {"launches": launches, "captured": captured,
            "replays": replays, "warmup_launches": eager_launches,
            "ms_per_step": graph_ms, "ms_per_step_eager": eager_ms,
            "step_ms": graph_step_ms, "step_ms_eager": eager_step_ms,
            "busy_share": busy}


def profile_train(torch, tr, batches, card, name, alone=False):
    """Two training steps under torch.profiler: device time by kernel and
    the device's busy share of the traced wall (not gated).  The steps run
    through ``run()``, which renders each batch on the card in the loop,
    or with ``alone`` through ``step_fn`` on batches rendered before the
    trace.  Returns the busy share, None where the profiler recorded no
    device time."""
    from torch.profiler import ProfilerActivity, profile

    state = tr.init_state(SEED)
    it = batches()
    state, _ = tr.run(state, it, 1, log_fn=lambda _: None)  # the capture
    ready = [next(it) for _ in range(2)] if alone else None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        if alone:
            for b in ready:
                state, _ = tr.step_fn(state, b)
        else:
            tr.run(state, it, 2, log_every=2, log_fn=lambda _: None)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_us = device_time_us(torch, prof)
    busy_ms = sum(device_us.values()) / 1e3
    if busy_ms == 0:
        print(f"profile train[{name}]: the profiler recorded no device time: "
              f"not measured")
        return None
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:8]
    # the aer kernel by variant: merged = layer 0, narrow = layer 1
    by_variant = {v: sum(us for k, us in device_us.items()
                         if f"aer_{v}_kernel" in k) / 1e3
                  for v in ("merged", "rows", "narrow", "split")}
    aer_ms = sum(by_variant.values())
    split = ", ".join(f"{v} {ms:.3f} ms" for v, ms in by_variant.items() if ms)
    where = "rendered before the trace" if alone else "rendered in the loop"
    print(f"profile train[{name}]: traced wall {wall_ms:.1f} ms over 2 steps "
          f"(batches {where}) | device busy {busy_ms:.1f} ms "
          f"({busy_ms / wall_ms:.1%}) | aer kernel {aer_ms:.3f} ms "
          f"({aer_ms / busy_ms:.1%} of busy; {split}; {aer_ms / 2:.3f} ms a "
          f"step) | on {card}")
    for kname, us in top:
        print(f"profile train[{name}]:   {us / 1e3:8.3f} ms  {kname[:90]}")
    return busy_ms / wall_ms


def kernel_ms(fn, reps=20):
    """Device time of one call (``device_ms``); CUDA-event time per call
    where the profiler recorded no device time."""
    ms = device_ms(fn, reps)
    if ms is None:
        print("timing: the profiler recorded no device time; CUDA-event "
              "time per call is used instead")
        return cuda_ms(fn, reps=reps, rounds=3)
    return ms


def timed(kernel, plain, library=None):
    """Times of one call (ms): device time of the kernel's wrapper, its
    plain version and its library yardstick (``kernel_ms``), and the
    kernel's per-call time from CUDA events around back-to-back calls,
    which the wrapper's host time paces when it is the longer."""
    return {"ms": kernel_ms(kernel, 20), "plain_ms": kernel_ms(plain, 5),
            "library_ms": None if library is None else kernel_ms(library, 20),
            "call_ms": cuda_ms(kernel)}


def hw_forward(ops, snn, params, spikes, refractory):
    """The hardware path layer by layer; every layer's output spikes."""
    outs, h = [], spikes
    for i in range(len(params)):
        lp = params[f"layer{i}"]
        h = ops.snn_layer_forward(h, lp["w"], lp["b"], snn.effective_beta(lp),
                                  lp["threshold"], refractory_steps=refractory)
        outs.append(h)
    return outs


def hw_forward_eager(ops, snn, quant, params, spikes, refractory):
    """The hardware path in its former dataflow: the bias add, the int32 ->
    float32 conversion and the divide by 2^15 as three eager ops between
    ``spike_matmul`` and the float form of the LIF kernel."""
    import torch

    h = spikes
    for i in range(len(params)):
        lp = params[f"layer{i}"]
        T, B, K = h.shape
        acc = ops.spike_matmul(h.reshape(T * B, K).to(torch.int8),
                               quant.quantize(lp["w"]))
        acc = acc + quant.quantize(lp["b"]).to(torch.int32)[None, :]
        cur = (acc.to(torch.float32) / quant.Q1_15.scale).reshape(T, B, -1)
        h, _ = ops.lif_fused(cur, snn.effective_beta(lp), lp["threshold"],
                             refractory_steps=refractory)
    return h


def forward_profile(torch, fn, reps=5, runs=3):
    """(device ms, device operations) of one call of ``fn``: kernels,
    copies and fills that ``torch.profiler`` saw on the card (``per_call``),
    the median over ``runs`` profiler runs of ``reps`` calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    got = []
    for _ in range(runs):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ms, ops = per_call(torch, prof, reps)
        if ms is not None:
            got.append((ms, ops))
    if not got:
        return None, 0
    got.sort()
    return got[len(got) // 2]


def hw_inputs(torch, dev, params_np):
    """Params on the card, the rate-coded (T, B, 4096) train of B collision
    images, each frame's busiest coded step as an event list, and the Q1.15
    operands of the two ``q115_matmul`` shapes."""
    import numpy as np

    from repro_torch.configs.collision_snn import CONFIG
    from repro_torch.core import coding, quant, snn
    from repro_torch.events import runtime

    params = snn.params_from_numpy(params_np, dev)
    x = torch.from_numpy(images(HW_BATCH, SEED + 5)).to(dev)
    spikes = coding.rate_encode_deterministic(x, CONFIG.num_steps)
    K = spikes.shape[-1]
    # deterministic coding fires a pixel first once t * p reaches 1, so the
    # first steps are nearly silent: take the busiest step for the events
    t_ev = int(spikes.sum((1, 2)).argmax())
    addrs, values, _ = runtime.step_events(spikes[t_ev], K)  # (B, K) each
    wq = [quant.quantize(params[f"layer{i}"]["w"]) for i in range(len(params))]
    rng = np.random.default_rng(SEED + 6)
    xq = rng.integers(-(2**15), 2**15, (spikes.shape[0] * HW_BATCH, K))
    xq[0] = -(2**15)  # the extreme code, whose square is 2^30
    bench = [rng.integers(-(2**15), 2**15, s) for s in ((128, 512), (512, 128))]
    # name: (x, w, saturate): kernel_bench's shape saturates as it does;
    # the 4096-wide sum is kept raw, since it would saturate
    q_cases = {
        "200x4096x512": (torch.from_numpy(xq.astype(np.int16)).to(dev), wq[0],
                         False),
        "128x512x128": (*(torch.from_numpy(b.astype(np.int16)).to(dev)
                          for b in bench), True),
    }
    return params, spikes, t_ev, addrs, values.to(torch.int8), wq, q_cases


def phase_hw_path(torch, dev, params_np, card):
    """Phase 7: the paper's Fig. 5 hardware path through the public kernel
    API on the card, then the API's event and Q1.15 products."""
    from unittest import mock

    from repro_torch.configs.collision_snn import CONFIG
    from repro_torch.core import energy, quant, snn
    from repro_torch.kernels import lif_fused as lif_mod
    from repro_torch.kernels import ops, ref

    params, spikes, t_ev, addrs, values, wq, q_cases = hw_inputs(
        torch, dev, params_np)
    B = HW_BATCH
    counted = (ops.spike_matmul, ops.lif_fused, ops.aer_spike_matmul,
               ops.q115_matmul)

    def run():
        outs = {r: hw_forward(ops, snn, params, spikes, r) for r in (0, 5)}
        aer = [ops.aer_spike_matmul(addrs[b], values[b], wq[0]) for b in range(B)]
        q = {name: ops.q115_matmul(x, w, saturate=sat)
             for name, (x, w, sat) in q_cases.items()}
        return outs, aer, q

    run()  # warm-up: first launches, allocator
    torch.cuda.synchronize()
    for fn in counted:  # the main path: counts from 0, read right after
        fn.launches = 0
    outs, aer, q = run()
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counted}
    L = CONFIG.num_layers
    want = {"spike_matmul": 2 * L, "lif_fused": 2 * L, "aer_spike_matmul": B,
            "q115_matmul": len(q_cases)}
    if launches != want:
        fail(f"hardware path launches {launches}, want {want}")

    with mock.patch.object(ops, "spike_matmul", ref.spike_matmul_ref), \
            mock.patch.object(ops, "lif_fused", ref.lif_fused_ref), \
            mock.patch.object(ops, "lif_fused_from_acc",
                              lif_mod.lif_fused_from_acc_ref):
        plain = {r: hw_forward(ops, snn, params, spikes, r) for r in (0, 5)}
    for r in (0, 5):
        for i, (got, exp) in enumerate(zip(outs[r], plain[r])):
            if got.shape != (CONFIG.num_steps, B, CONFIG.layer_sizes[i + 1]):
                fail(f"hardware path layer {i}: shape {tuple(got.shape)}")
            if not torch.equal(got, exp):
                fail(f"hardware path, refractory {r}, layer {i}: spikes differ "
                     f"from the forward through the plain versions")
    dense = ref.spike_matmul_ref(spikes[t_ev].to(torch.int8), wq[0])
    for b in range(B):
        if not torch.equal(aer[b], dense[b]):
            fail(f"aer_spike_matmul frame {b}: differs from the dense product")
    for name, (x, w, sat) in q_cases.items():
        exp = (ref.q115_matmul_ref if sat else ref.q115_matmul_acc_ref)(x, w)
        if not torch.equal(q[name], exp):
            fail(f"q115_matmul {name}: differs from its plain version")

    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hw_forward(ops, snn, params, spikes, 0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls)
    cfg = snn.SNNConfig(layer_sizes=CONFIG.layer_sizes,
                        num_steps=CONFIG.num_steps)
    rates = snn.hidden_spike_rates(params, spikes, cfg)
    opcount = energy.snn_inference_ops(
        cfg.layer_sizes, cfg.num_steps,
        [float(spikes.mean())] + [float(x) for x in rates][:-1],
    )
    qat = snn.SNNConfig(layer_sizes=CONFIG.layer_sizes,
                        num_steps=CONFIG.num_steps, quant_q115=True)
    _, float_spk = snn.forward(params, spikes, qat)
    agree = int((outs[0][-1].sum(0).argmax(-1) ==
                 float_spk.sum(0).argmax(-1)).sum())
    counts = {r: [int(o.sum()) for o in outs[r]] for r in (0, 5)}
    print(f"hardware path: {'-'.join(map(str, CONFIG.layer_sizes))} "
          f"T={CONFIG.num_steps} B={B}, input spikes {int(spikes.sum())} | "
          f"launches {launches} | output spikes per layer: refractory 0 "
          f"{counts[0]}, refractory 5 {counts[5]} (equal to the plain-"
          f"version forward) | {wall_ms:.3f} ms/forward | on {card}")
    print(f"hardware path: hidden spike rates {[round(float(x), 5) for x in rates]}"
          f" -> {opcount.total_ops():.4e} ops, {opcount.energy_pj():.4e} pJ "
          f"per inference (table 4's event model) | argmax agrees with the "
          f"Q1.15 float graph on {agree}/{B} (not gated)")
    # the forward's device time, against the former three-op dataflow
    eager = hw_forward_eager(ops, snn, quant, params, spikes, 0)
    if not torch.equal(eager, outs[0][-1]):
        fail("hardware path: the three-op forward differs from the fused one")
    fused_ms, fused_n = forward_profile(
        torch, lambda: hw_forward(ops, snn, params, spikes, 0))
    eager_ms, eager_n = forward_profile(
        torch, lambda: hw_forward_eager(ops, snn, quant, params, spikes, 0))
    print(f"hardware path: device time a forward (torch.profiler) "
          f"{fused_ms or 0:.4f} ms in {fused_n} device operations | "
          f"with the bias add, conversion and divide as three eager ops "
          f"before a float LIF launch (the former dataflow) {eager_ms or 0:.4f} ms in "
          f"{eager_n} | same output spikes | on {card}")
    return {"launches": launches, "wall_ms": wall_ms, "params": params,
            "spikes": spikes, "hidden": outs[0][0], "t_ev": t_ev, "addrs": addrs,
            "values": values, "wq": wq, "q_cases": q_cases}


def _layer_acc(torch, ref, spk_i8, wq, b, T):
    """A layer's adder-tree sums (T, B, N) int32 and int32 bias codes."""
    from repro_torch.core import quant

    acc = ref.spike_matmul_ref(spk_i8, wq).reshape(T, HW_BATCH, -1)
    return acc, quant.quantize(b).to(torch.int32)


def lif_floor_ms(torch, B, N):
    """Device time of an empty kernel on the LIF kernel's grid for (B, N)
    (``lif_empty_launch`` in csrc/lif_fused.cu): the launch-and-schedule
    floor of its device time."""
    import ctypes

    from repro_torch.kernels import _build

    _build.load("lif_fused")
    fn = ctypes.CDLL(str(_build.library_path("lif_fused"))).lif_empty_launch
    fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call():
        if fn(B, N, torch.cuda.current_stream().cuda_stream) != 0:
            fail("the empty kernel did not launch")

    return device_ms(call, reps=50)


def q115_pair_rate(torch):
    """Products a second of q115_matmul's inner instruction pair alone
    (``q115_rate_launch``: 4 CTAs of 256 threads an SM, 2,000 rounds of 32
    products a thread), from CUDA events around back-to-back launches of
    this half-millisecond kernel."""
    import ctypes

    from repro_torch.kernels import _build

    _build.load("q115_matmul")
    fn = ctypes.CDLL(str(_build.library_path("q115_matmul"))).q115_rate_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks, threads, rounds = 132 * 4, 256, 2000
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")

    def call():
        if fn(out.data_ptr(), blocks, threads, rounds,
              torch.cuda.current_stream().cuda_stream) != 0:
            fail("the q115 rate kernel did not launch")

    ms = cuda_ms(call, reps=10, rounds=3)
    return blocks * threads * rounds * 32 / (ms * 1e-3)


def phase_ops_kernels(torch, dev, hw, card):
    """Phase 8: each kernel of the public API against its plain version at
    the hardware path's shapes; times, bounds, library yardsticks."""
    import torch.nn.functional as F

    from repro_torch.core import quant, snn
    from repro_torch.kernels import lif_fused as lif_mod
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import q115_matmul as q_mod

    params, spikes, wq = hw["params"], hw["spikes"], hw["wq"]
    T = spikes.shape[0]
    planes = [spikes.reshape(T * HW_BATCH, -1).to(torch.int8),
              hw["hidden"].reshape(T * HW_BATCH, -1).to(torch.int8)]
    out = {}

    # lif_fused, both input forms: float currents, and the adder tree's
    # int32 sums with the int32 bias (ops.snn_layer_forward's form)
    worst = 0.0
    for i, plane in enumerate(planes):
        lp = params[f"layer{i}"]
        acc, bq = _layer_acc(torch, ref, plane, wq[i], lp["b"], T)
        cur = (acc + bq).to(torch.float32) / quant.Q1_15.scale
        beta, thr = snn.effective_beta(lp), lp["threshold"]
        forms = (("float", ops.lif_fused, ref.lif_fused_ref, (cur, beta, thr)),
                 ("int32", lif_mod.lif_fused_from_acc,
                  lif_mod.lif_fused_from_acc_ref, (acc, bq, beta, thr)))
        for reset in ("zero", "subtract"):
            for r in (0, 5):
                kw = dict(refractory_steps=r, reset=reset)
                for form, fn, plain, a in forms:
                    got, exp = fn(*a, **kw), plain(*a, **kw)
                    torch.cuda.synchronize()
                    err = float((got[1] - exp[1]).abs().max())
                    if not (torch.equal(got[0], exp[0]) and
                            torch.equal(got[1], exp[1])):
                        fail(f"lif_fused ({form}) layer {i} {reset} refractory "
                             f"{r}: differs from its plain version (max |d u| "
                             f"{err})")
                    worst = max(worst, err)
        if i == 0:
            args, acc_args = (cur, beta, thr), (acc, bq, beta, thr)
    Tn, Bn, N = args[0].shape
    bound = bound_of((2 * Tn * Bn * N + Bn * N + 2 * N) * 4, 5 * Tn * Bn * N,
                     F32_FLOPS)
    out["lif_fused"] = {**timed(lambda: ops.lif_fused(*args),
                               lambda: ref.lif_fused_ref(*args)),
                        "bound_by": bound[0], "bound_ms": bound[1],
                        "max_abs_err": worst}
    out["lif_fused"]["extra"] = {
        "ms_from_acc": kernel_ms(lambda: lif_mod.lif_fused_from_acc(*acc_args)),
        "plain_ms_from_acc": kernel_ms(
            lambda: lif_mod.lif_fused_from_acc_ref(*acc_args), 5),
        "floor_ms": lif_floor_ms(torch, Bn, N),
    }
    lif_x = out["lif_fused"]["extra"]
    print(f"ops kernel[lif_fused]: ({Tn}, {Bn}, {N}) on "
          f"{-(-Bn * N // lif_mod.THREADS)} CTAs of {lif_mod.THREADS} threads"
          f" | float form {out['lif_fused']['ms']:.5f}"
          f" ms, int32 form {lif_x['ms_from_acc']:.5f} ms (plain "
          f"{lif_x['plain_ms_from_acc']:.4f} ms) | an empty kernel on the same "
          f"grid {lif_x['floor_ms'] or 0:.5f} ms (the floor) | bytes bound "
          f"{bound[1]:.5f} ms | on {card}")

    # spike_matmul
    for i, plane in enumerate(planes):
        if not torch.equal(ops.spike_matmul(plane, wq[i]),
                           ref.spike_matmul_ref(plane, wq[i])):
            fail(f"spike_matmul layer {i}: differs from its plain version")
    from repro_torch.kernels import spike_matmul as smm_mod

    for i, plane in enumerate(planes):
        geo = smm_mod.plan(*plane.shape, wq[i].shape[1])
        print(f"spike_matmul geometry[layer {i}]: {tuple(plane.shape)} x "
              f"{tuple(wq[i].shape)}, tiles {smm_mod.TILE_M} x {smm_mod.TILE_N}"
              f" x {smm_mod.TILE_K} (m, n, k), {geo.m_tiles} x {geo.n_tiles} "
              f"tiles x split-K {geo.split} ({geo.slabs_per_split} of "
              f"{geo.slabs} slabs each) = {geo.ctas} CTAs of 256 threads")
    s0, w0 = planes[0], wq[0]
    M, K = s0.shape
    N = w0.shape[1]
    sd, wd = s0.double(), w0.double()  # the casts stay outside the timed call
    lib_exact = torch.equal(torch.matmul(sd, wd).to(torch.int32),
                            ops.spike_matmul(s0, w0))
    bound = bound_of(M * K + K * N * 2 + M * N * 4, 4 * M * K * N, INT8_TC_OPS)
    out["spike_matmul"] = {**timed(lambda: ops.spike_matmul(s0, w0),
                                   lambda: ref.spike_matmul_ref(s0, w0),
                                   lambda: torch.matmul(sd, wd)),
                           "bound_by": bound[0], "bound_ms": bound[1],
                           "max_abs_err": 0.0, "nonzero": int((s0 != 0).sum()),
                           "alone_ms": device_ms(lambda: ops.spike_matmul(s0, w0),
                                                 only="spike_matmul_kernel")}

    # aer_spike_matmul
    addrs, values = hw["addrs"], hw["values"]
    dense = ref.spike_matmul_ref(spikes[hw["t_ev"]].to(torch.int8), w0)
    for b in range(HW_BATCH):
        got = ops.aer_spike_matmul(addrs[b], values[b], w0)
        if not (torch.equal(got, ref.aer_spike_matmul_ref(addrs[b], values[b], w0))
                and torch.equal(got, dense[b])):
            fail(f"aer_spike_matmul frame {b}: differs from its plain version "
                 f"or from spike_matmul on the same row")
    a0, v0 = addrs[0], values[0]
    vd, wd0 = v0.double()[None], w0.double()
    bound, work = aer_bound(a0[None], v0[None], w0)
    out["aer_spike_matmul"] = {
        **timed(lambda: ops.aer_spike_matmul(a0, v0, w0),
                lambda: ref.aer_spike_matmul_ref(a0, v0, w0),
                lambda: F.embedding_bag(a0[None], wd0, per_sample_weights=vd,
                                        mode="sum")),
        "bound_by": bound[0], "bound_ms": bound[1], "max_abs_err": 0.0,
        "events": work["events"]}

    # q115_matmul
    for name, (x, w, _) in hw["q_cases"].items():
        for sat in (True, False):
            plain = ref.q115_matmul_ref if sat else ref.q115_matmul_acc_ref
            if not torch.equal(ops.q115_matmul(x, w, saturate=sat), plain(x, w)):
                fail(f"q115_matmul {name} saturate={sat}: differs from its "
                     f"plain version")
            geo = q_mod.plan(*x.shape, w.shape[1], sat)
            print(f"q115_matmul geometry[{name} "
                  f"{'saturate' if sat else 'raw'}]: tiles "
                  f"{q_mod.ROWS_PER_WARP * geo.warps} x {q_mod.TILE_N} (m, n), "
                  f"{geo.m_tiles} x {geo.n_tiles} tiles x split-K {geo.split} "
                  f"({geo.k_per_split} k each, clusters of {geo.cluster}"
                  f"{', atomicAdd across them' if geo.atomic else ''}) = "
                  f"{geo.ctas} CTAs of {32 * geo.warps} threads")
    q_times = {}
    for name, (x, w, _) in hw["q_cases"].items():
        M, K = x.shape
        N = w.shape[1]
        # two integer instructions a product (IMAD, LEA.HI.SX32: the SASS),
        # bound by issue; the former count, 3 on 64 lanes an SM, is kept
        # as the superseded bound
        bound = bound_of(M * K * 2 + K * N * 2 + M * N * 4, 2 * M * K * N,
                         INT_ISSUE_OPS)
        q_times[name] = {
            **timed(lambda: ops.q115_matmul(x, w, saturate=False),
                    lambda: ref.q115_matmul_acc_ref(x, w)),
            "ms_saturate": kernel_ms(lambda: ops.q115_matmul(x, w)),
            "alone_ms": device_ms(lambda: ops.q115_matmul(x, w, saturate=False),
                                  only="q115_matmul_kernel"),
            "bound_by": bound[0], "bound_ms": bound[1],
            "bound_superseded_ms": 3 * M * K * N / INT32_OPS * 1e3,
            "max_abs_err": 0.0}
    rate = q115_pair_rate(torch)
    big = q_times["200x4096x512"]
    print(f"q115_matmul bound: 2 integer instructions a product (IMAD on the "
          f"FMA pipe, LEA.HI.SX32 on the ALU pipe) issued at {INT_ISSUE_OPS:.4e}"
          f" a second = 64 products a clock an SM: {big['bound_ms']:.5f} ms at "
          f"200x4096x512 (superseded 3-operation count "
          f"{big['bound_superseded_ms']:.5f} ms) | the pair alone on every SM "
          f"{rate:.4e} products/s ({rate / (132 * 1.98e9):.1f} a "
          f"clock an SM at 1.98 GHz) | on {card}")
    for name, rec in q_times.items():
        print(f"q115_matmul time[{name}]: raw {rec['ms']:.4f} ms (kernel alone "
              f"{rec['alone_ms'] or 0:.4f}), saturated {rec['ms_saturate']:.4f}"
              f" ms | bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}), "
              f"{rec['ms'] / rec['bound_ms']:.2f}x | on {card}")
    out["q115_matmul"] = {**big, "extra": {
        "pair_products_per_s": rate,
        "bound_superseded_ms": big["bound_superseded_ms"],
        "cases": {k: {f: v[f] for f in ("ms", "ms_saturate", "alone_ms",
                                        "plain_ms", "bound_ms")}
                  for k, v in q_times.items()}}}

    rows = [(k, v) for k, v in out.items() if k != "q115_matmul"]
    for name, rec in rows + [("q115_matmul " + k, v) for k, v in q_times.items()]:
        lib = rec["library_ms"]
        print(f"ops kernel[{name}]: bit-exact | kernel {rec['ms']:.4f} ms "
              f"(per call {rec['call_ms']:.4f} ms) | "
              f"plain {rec['plain_ms']:.4f} ms | library "
              f"{'none' if lib is None else f'{lib:.4f} ms'} | bound "
              f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}) | on {card}")
    print(f"ops kernel[spike_matmul]: layer 0 {tuple(s0.shape)} x "
          f"{tuple(w0.shape)}, {out['spike_matmul']['nonzero']} nonzero "
          f"spikes; the kernel alone {out['spike_matmul']['alone_ms'] or 0:.4f}"
          f" ms of the call's device time (the rest zeroes the split-K "
          f"output); library = torch.matmul in float64 on operands cast "
          f"before the timed call (exact: {lib_exact}) | aer: "
          f"{out['aer_spike_matmul']['events']} events of frame 0's step "
          f"{hw['t_ev']}; library = F.embedding_bag(mode='sum') in float64 | "
          f"lif_fused, q115_matmul: no single PyTorch call computes a "
          f"thresholded recurrence or per-product rounding | kernel, plain "
          f"and library times are device time per call (torch.profiler); "
          f"'per call' is CUDA events around back-to-back calls")
    return out


def ops_rows(hw, ops_k):
    """Kernel-table rows of the public API's kernels (phases 7 and 8)."""
    return [{
        "name": name,
        "route": "cuda",
        "source": f"src/repro_torch/kernels/csrc/{source}.cu",
        "replaces": replaces,
        "launches": hw["launches"][name],
        **{k: ops_k[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                       "bound_ms", "bound_by", "library_ms")},
        **ops_k[name].get("extra", {}),
    } for name, source, replaces in (
        ("lif_fused", "lif_fused", "src/repro/kernels/lif_fused.py:82"),
        ("spike_matmul", "spike_matmul", "src/repro/kernels/spike_matmul.py:67"),
        ("aer_spike_matmul", "aer_matmul", "src/repro/kernels/aer_matmul.py:195"),
        ("q115_matmul", "q115_matmul", "src/repro/kernels/q115_matmul.py:60"),
    )]


# --------------------------------------------------------------------------
# Phase 10: the event input path
# --------------------------------------------------------------------------
DVS_HW, DVS_SERVED, DVS_HELD_OUT, AER_BATCH, BCNN_IMAGES = 64, 48, 16, 32, 64


def dvs_inputs(torch, dev):
    """64 synthetic 64x64 DVS recordings drawn on the card (48 to serve,
    16 held out), as AER streams and as signed and two-channel planes."""
    from repro_torch.configs.collision_snn import CONFIG
    from repro_torch.events import aer

    T, P = CONFIG.num_steps, DVS_HW * DVS_HW
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    stream, labels = aer.dvs_collision_batch(
        gen, DVS_SERVED + DVS_HELD_OUT, image_hw=DVS_HW, num_steps=T,
        capacity=8 * P)
    planes = {pol: aer.input_planes(stream, T, P, polarity_mode=pol)
              for pol in ("signed", "two_channel")}
    return stream, labels, planes


def dvs_engines(torch, dev, params, cfg):
    """Engine factory at serving geometry for one network."""
    from repro_torch.serving.snn_engine import SNNStreamEngine

    def engine(backend, **kw):
        return SNNStreamEngine(params, cfg, num_slots=SLOTS, chunk_steps=TC,
                               backend=backend, device=dev, **kw)

    return engine


def serve_dvs(torch, name, engine, reqs, card):
    """The graph engine on ``reqs`` (counts from 0, read right after),
    held against the eager engine and the plain chunk field for field."""
    engine("fused").run(reqs[:2])  # warm-up: allocator, capture
    torch.cuda.synchronize()
    eng = engine("fused")
    results, wall, eager = serve_counted(torch, eng, reqs)
    check_clean(f"dvs[{name}]", eng)
    if eager != eng.graph_captures:
        fail(f"dvs[{name}]: {eager} eager snn_chunk launches for "
             f"{eng.graph_captures} capture(s)")
    for r in results:
        if r.disposition != "ok" or r.prediction not in (0, 1) or not (
                r.events_per_layer[0] > 0 and r.energy_pj > 0):
            fail(f"dvs[{name}] request {r.request_id}: {r.disposition} "
                 f"{r.fault} {r.events_per_layer} {r.energy_pj}")
    got = [fault_fields(r) for r in results]
    base = engine("fused", cuda_graph=False)
    if [fault_fields(r) for r in serve_counted(torch, base, reqs)[0]] != got:
        fail(f"dvs[{name}]: the graph engine differs from the eager engine")
    check_no_retries(f"dvs[{name}] eager", base)
    if [fault_fields(r) for r in engine("fused_ref").run(reqs)] != got:
        fail(f"dvs[{name}]: the graph engine differs from the plain chunk")
    events = float(sum(r.events_per_layer.sum() for r in results))
    rec = {"ms_tick": wall / eng.dispatched_ticks * 1e3,
           "req_s": len(results) / wall, "events_s": events / wall,
           "energy_nj": statistics.mean(r.energy_pj for r in results) / 1e3,
           "launches": eager + eng.graph_replays, "ticks": eng.dispatched_ticks,
           "results": results}
    print(f"dvs[{name}]: {len(results)} requests ok in {wall:.3f} s over "
          f"{eng.dispatched_ticks} ticks = {eng.graph_replays} graph replays "
          f"+ {eager} warm-up launch(es), admission {eng.admit_replays} "
          f"replays of {eng.admit_captures} capture(s), steady-state re-captures "
          f"{eng.steady_state_recompiles()} | {rec['ms_tick']:.3f} ms/tick | "
          f"{rec['req_s']:.1f} req/s | {rec['events_s']:.0f} events/s | mean "
          f"{rec['energy_nj']:.1f} nJ a request (45 nm model) | equal to the "
          f"eager engine and the plain chunk in every field | on {card}")
    return rec


def chunk_case(torch, dev, params, planes, C, card, name):
    """``snn_chunk`` on the first chunk (steps 0-4, the dense reference
    frame included) of 8 recordings staged at capacity C: device time a
    call and of the kernel alone, and its outputs."""
    from repro_torch.core import snn
    from repro_torch.events import runtime
    from repro_torch.kernels import snn_chunk as chunk_mod

    x = planes[:TC, :SLOTS].transpose(0, 1).contiguous()  # (B, Tc, K)
    tab = runtime.encode_step_table(x, C)
    L = len(params)
    lp = [params[f"layer{i}"] for i in range(L)]
    widths = [x.shape[-1]] + [p["w"].shape[1] for p in lp]
    args = ([p["w"] for p in lp], [p["b"] for p in lp],
            [snn.effective_beta(p) for p in lp], [p["threshold"] for p in lp],
            [torch.zeros(SLOTS, n, device=dev) for n in widths[1:]],
            [torch.zeros(SLOTS, n, dtype=torch.int32, device=dev)
             for n in widths[1:]],
            tab.addrs, tab.values, tab.counts, torch.ones(SLOTS, device=dev))
    call = lambda: chunk_mod.snn_chunk(*args, layout="slot_major")  # noqa: E731
    out = call()
    rec = {"ms": kernel_ms(call), "C": C,
           "alone_ms": device_ms(call, only="snn_chunk_kernel"),
           "events": int(tab.counts.sum())}
    print(f"dvs chunk[{name}]: C={C}, {rec['events']} layer-0 events over "
          f"steps 0-{TC - 1} of {SLOTS} recordings | snn_chunk "
          f"{rec['ms']:.4f} ms device a call (kernel alone "
          f"{rec['alone_ms'] or 0:.4f} ms) | on {card}")
    return rec, out


def phase_events(torch, dev, params_np, card, main_run):
    """Phase 10: DVS serving, capacity tuning, AER-direct inference and
    the BCNN baseline with the energy comparison, at full width."""
    from unittest import mock

    import numpy as np

    from repro_torch.configs.collision_snn import CONFIG
    from repro_torch.core import bcnn, energy, snn
    from repro_torch.data import collision
    from repro_torch.events import aer, capacity, runtime
    from repro_torch.kernels import aer_matmul as aer_mod
    from repro_torch.optim import adam
    from repro_torch.serving.snn_engine import StreamRequest
    from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

    T = CONFIG.num_steps
    stream, _, planes = dvs_inputs(torch, dev)
    cfgs = {"signed": CONFIG,  # 4096-512-2
            "two_channel": snn.SNNConfig(  # 8192-512-2
                layer_sizes=(2 * CONFIG.layer_sizes[0],)
                + tuple(CONFIG.layer_sizes[1:]), num_steps=T)}
    params = {"signed": snn.params_from_numpy(params_np, dev),
              "two_channel": snn.params_from_numpy(
                  weights_np(cfgs["two_channel"].layer_sizes, SEED), dev)}
    host = {pol: p.cpu().numpy() for pol, p in planes.items()}
    reqs = {pol: [StreamRequest(spikes=h[:, i]) for i in range(DVS_SERVED)]
            for pol, h in host.items()}
    engines = {pol: dvs_engines(torch, dev, params[pol], cfgs[pol])
               for pol in cfgs}

    # 10a. DVS serving on the graph engine
    served = {pol: serve_dvs(torch, pol, engines[pol], reqs[pol], card)
              for pol in cfgs}
    rate = main_run["rate_coded"]
    print(f"dvs vs rate-coded (the paper's claim in miniature, "
          f"{'-'.join(map(str, CONFIG.layer_sizes))}): "
          f"signed DVS {served['signed']['energy_nj']:.1f} nJ, "
          f"{served['signed']['ms_tick']:.3f} ms/tick, "
          f"{served['signed']['req_s']:.1f} req/s, "
          f"{served['signed']['events_s']:.0f} events/s | rate-coded "
          f"(phase 4) {rate['energy_nj']:.1f} nJ, {rate['ms_tick']:.3f} "
          f"ms/tick, {rate['req_s']:.1f} req/s, {rate['events_s']:.0f} "
          f"events/s | energy is the 45 nm model priced from counted events")

    # 10b. capacity plans from counts measured on the card
    plans, cases = {}, {}
    for pol, cfg in cfgs.items():
        sample = planes[pol][:, :DVS_SERVED]
        counts = {b: capacity.measure_step_counts(params[pol], cfg, sample,
                                                  backend=b)
                  for b in ("fused", "fused_ref", "torch")}
        if not (counts["fused"] == counts["fused_ref"]).all():
            fail(f"capacity[{pol}]: the kernel's counts differ from its "
                 f"plain version's")
        if not (counts["fused"][0] == counts["torch"][0]).all():
            fail(f"capacity[{pol}]: layer-0 counts differ from torch's")
        plan = capacity.autotune(params[pol], cfg, sample,
                                 counts=counts["fused"])
        if plan.capacities != capacity.autotune(
                params[pol], cfg, sample, counts=counts["torch"]).capacities:
            fail(f"capacity[{pol}]: the plan on torch's counts differs")
        plans[pol] = plan
        hidden = np.abs(counts["fused"][1:] - counts["torch"][1:])
        print(f"capacity[{pol}]: plan {plan.capacities} of fan-in "
              f"{plan.fan_in} | shrink {[round(x, 3) for x in plan.shrink]} | "
              f"max_count {plan.max_count} | pct_count {plan.pct_count} | "
              f"dropped_events_frac {plan.dropped_events_frac} | counts "
              f"through backend='fused' equal the plain chunk's in all "
              f"{counts['fused'].size} lists, and backend='torch' in layer 0 "
              f"and the plan; torch's hidden counts differ in "
              f"{int((hidden > 0).sum())} of {hidden.size} lists by up to "
              f"{int(hidden.max()) if hidden.size else 0} (its layer-0 sums "
              f"run in another order; not gated)")
    tuned_pol = min(plans, key=lambda p: plans[p].capacities[0] / plans[p].fan_in[0])
    plan = plans[tuned_pol]
    C = plan.capacities[0]
    if C >= plan.fan_in[0]:
        fail(f"capacity: no plan shrinks layer 0 ({plans})")
    tuned = engines[tuned_pol]("fused", capacities=plan.capacities)
    t_results, t_wall, t_eager = serve_counted(torch, tuned, reqs[tuned_pol])
    check_clean("capacity tuned engine", tuned)
    if [fault_fields(r) for r in t_results] != [
            fault_fields(r) for r in served[tuned_pol]["results"]]:
        fail("capacity: the tuned engine differs from the untuned one")
    full = engines[tuned_pol]("fused")
    ring = {name: sum(v.nbytes for v in e._ring.values())
            for name, e in (("tuned", tuned), ("full", full))}
    outs = {}
    for pol in cfgs:
        cases[f"dvs_{pol}"], outs[pol] = chunk_case(
            torch, dev, params[pol], planes[pol], cfgs[pol].layer_sizes[0],
            card, pol)
    cases["tuned_C"], tuned_out = chunk_case(
        torch, dev, params[tuned_pol], planes[tuned_pol], C, card,
        f"{tuned_pol} tuned")
    # launches of each case's serving run (replays + warm-ups)
    for pol in cfgs:
        cases[f"dvs_{pol}"]["launches"] = served[pol]["launches"]
    cases["tuned_C"]["launches"] = t_eager + tuned.graph_replays
    if not all(torch.equal(a, b) for a, b in
               zip(tree_leaves(list(tuned_out)),
                   tree_leaves(list(outs[tuned_pol])))):
        fail("capacity: snn_chunk at the tuned C differs from fan-in")
    print(f"capacity[{tuned_pol}]: engine at C={C} serves the {DVS_SERVED} "
          f"requests equal to the untuned engine in every field | "
          f"{t_wall / tuned.dispatched_ticks * 1e3:.3f} ms/tick | staged ring "
          f"bytes {ring['tuned']} at C={C} vs {ring['full']} at "
          f"C={plan.fan_in[0]} | snn_chunk {cases['tuned_C']['ms']:.4f} vs "
          f"{cases[f'dvs_{tuned_pol}']['ms']:.4f} ms device a call | on {card}")
    held = planes[tuned_pol][:, DVS_SERVED:]
    reports = {b: capacity.truncation_report(params[tuned_pol],
                                             cfgs[tuned_pol], held, plan,
                                             backend=b)
               for b in ("fused", "fused_ref", "torch")}
    if reports["fused"] != reports["fused_ref"]:
        fail(f"capacity: the kernel's truncation report differs from the "
             f"plain chunk's: {reports}")
    differ = sorted(k for k in reports["fused"]
                    if reports["fused"][k] != reports["torch"][k])
    held_reqs = [StreamRequest(spikes=host[tuned_pol][:, DVS_SERVED + i])
                 for i in range(DVS_HELD_OUT)]
    overflow = sum(r.fault == "capacity_overflow"
                   for r in engines[tuned_pol](
                       "fused", capacities=plan.capacities).run(held_reqs))
    print(f"capacity[{tuned_pol}]: truncation_report on {DVS_HELD_OUT} "
          f"held-out recordings {reports['fused']} (equal to the plain "
          f"chunk's; backend='torch' differs in {differ or 'nothing'}: "
          f"{ {k: reports['torch'][k] for k in differ} }, not gated) | "
          f"capacity_overflow quarantines "
          f"{overflow}/{DVS_HELD_OUT}")

    # 10c. AER-direct inference on the aer kernel
    streams = aer.EventStream(*(x[:AER_BATCH] for x in stream))
    p = params["signed"]

    def forward():
        return runtime.event_forward_aer(p, streams, CONFIG)

    forward()  # warm-up
    torch.cuda.synchronize()
    aer_mod.aer_spike_matmul_batched.launches = 0
    t0 = time.perf_counter()
    got = forward()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = aer_mod.aer_spike_matmul_batched.launches
    if launches != T * CONFIG.num_layers:
        fail(f"event_forward_aer: {launches} aer launches, want T x L = "
             f"{T * CONFIG.num_layers}")
    with mock.patch.object(aer_mod, "aer_spike_matmul_batched",
                           aer_mod.aer_spike_matmul_batched_ref):
        plain = forward()
    if not all(torch.equal(a, b) for a, b in zip(got, plain)):
        fail("event_forward_aer: the kernel differs from its plain version")
    dense = runtime.event_forward(p, planes["signed"][:, :AER_BATCH], CONFIG,
                                  backend="fused")
    err = float((got[0] - dense[0]).abs().max())
    if not (torch.equal(got[1], dense[1]) and torch.equal(got[2], dense[2])
            and torch.allclose(got[0], dense[0], atol=1e-5, rtol=1e-5)):
        fail(f"event_forward_aer differs from event_forward on the planes "
             f"(membranes by {err})")
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    aer_ms = device_ms(forward, reps=3, only="aer_")
    window_ms = device_ms(forward, reps=3)
    print(f"aer inference: event_forward_aer B={AER_BATCH} T={T} "
          f"{'-'.join(map(str, CONFIG.layer_sizes))}, "
          f"{int(got[2][0].sum())} layer-0 and {int(got[2][1:].sum())} hidden "
          f"events, {int(got[1].sum())} output spikes | aer launches "
          f"{launches} (= T x L) | equal to the plain version; spikes and "
          f"events equal event_forward(fused) on the planes, membranes within "
          f"{err:.3g} | {statistics.median(walls):.3f} ms a window (host "
          f"clock; first {first_ms:.3f}) | device {window_ms or 0:.4f} ms a "
          f"window, of which the aer kernel {aer_ms or 0:.4f} ms | on {card}")

    # 10d. the BCNN baseline and the energy comparison
    bcfg = bcnn.BCNNConfig()
    x, y, _, _ = collision.generate(collision.CollisionConfig(
        image_hw=bcfg.input_hw, num_train=BCNN_IMAGES, num_test=0, seed=SEED))
    cpu_params = bcnn.init_params(torch.Generator().manual_seed(SEED), bcfg)
    bp = tree_map(lambda v: v.to(dev), cpu_params)
    xb, yb = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    card_logits = bcnn.forward(bp, xb, bcfg)
    cpu_logits = bcnn.forward(cpu_params, torch.from_numpy(x), bcfg)
    b_err = float((card_logits.cpu() - cpu_logits).abs().max())
    if not torch.allclose(card_logits.cpu(), cpu_logits, atol=1e-4, rtol=1e-4):
        fail(f"bcnn: the card's logits differ from the CPU's by {b_err}")
    live = tree_map(lambda v: v.detach().requires_grad_(True), bp)
    loss, aux = bcnn.loss_fn(live, xb, yb, bcfg)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    opt = adam(5e-4)
    updates, _ = opt.update(tree_unflatten(bp, list(grads)), opt.init(bp), bp)
    if not (torch.isfinite(loss) and all(
            bool(torch.isfinite(u).all()) for u in tree_leaves(updates))):
        fail(f"bcnn: training step loss {float(loss)} or update not finite")
    b_ms = cuda_ms(lambda: bcnn.forward(bp, xb, bcfg))
    ev = [statistics.mean(float(r.events_per_layer[i])
                          for r in served["signed"]["results"])
          for i in range(CONFIG.num_layers)]
    snn_ops = energy.snn_ops_from_events(CONFIG.layer_sizes, T, ev)
    small = energy.bcnn_inference_ops(*bcnn.conv_shapes_for_energy(bcfg))
    big = energy.bcnn36_inference_ops()
    print(f"bcnn: {bcfg.input_hw}x{bcfg.input_hw} channels {bcfg.channels}, "
          f"{BCNN_IMAGES} images on the card (TF32 off) within {b_err:.3g} of "
          f"the CPU | training step loss {float(loss.detach()):.4f} (finite) | "
          f"forward {b_ms:.4f} ms (CUDA events, cuDNN) | on {card}")
    print(f"energy (45 nm model estimate, not a measurement): SNN on the "
          f"measured signed DVS events (mean {[round(e) for e in ev]} a "
          f"request) {snn_ops.energy_pj() / 1e3:.1f} nJ | reduction vs "
          f"BCNN [36] at its published 2.04 GOP/frame "
          f"{energy.energy_reduction(snn_ops, big):.4f} | vs the small BCNN "
          f"({small.energy_pj() / 1e3:.1f} nJ) "
          f"{energy.energy_reduction(snn_ops, small):.4f} | paper: 0.86")
    return {"cases": cases, "aer_launches": launches,
            "served": {k: {f: v[f] for f in ("ms_tick", "req_s", "events_s",
                                             "energy_nj", "launches")}
                       for k, v in served.items()}}


# --------------------------------------------------------------------------
# Phase 11: the LM zoo's serving path
# --------------------------------------------------------------------------
LM_ARCH, LM_REQUESTS, LM_BATCH, LM_CACHE, LM_NEW = (
    "stablelm-1.6b", 8, 4, 128, 16)
# one full-width run for each other family whose float32 params fit the card
LM_FAMILIES = ("granite-moe-1b-a400m", "mamba2-130m", "recurrentgemma-2b",
               "minicpm3-4b", "phi-3-vision-4.2b", "musicgen-medium")
LM_GAP = 1e-3  # a generated position whose top-2 gap is smaller is skipped


def lm_requests(cfg, n, new_tokens, seed):
    """The launcher's requests (greedy): ``launch.serve.lm_requests``."""
    from repro_torch.launch.serve import lm_requests as make

    return make(cfg, n, new_tokens, seed=seed)


def lm_check(torch, dev, model, params, reqs, outs, B, cache_len):
    """The greedy check of one served run.  For each engine batch: the
    teacher-forced forward over the right-padded prompts (as the engine
    pads them) followed by the generated tokens; its argmax at each
    generated position must equal the token the engine generated there,
    but where the forward's top-2 gap is under ``LM_GAP``.  Also prefill
    and decode fed the same tokens: their largest logit difference from
    the forward's (printed, not gated).  (checked, skipped, mismatches,
    max |prefill/decode - forward|)."""
    import numpy as np

    cfg = model.cfg
    checked = skipped = bad = 0
    diff = 0.0
    for s in range(0, len(reqs), B):
        chunk, gen = reqs[s: s + B], np.stack(outs[s: s + B])
        Lmax = max(len(r.prompt) for r in chunk)
        new = gen.shape[1]
        pad = [np.pad(r.prompt, [(0, Lmax - len(r.prompt))]
                      + [(0, 0)] * (r.prompt.ndim - 1)) for r in chunk]
        tokens = torch.as_tensor(np.concatenate([np.stack(pad), gen], 1)
                                 ).to(dev)
        batch = {"tokens": tokens}
        if cfg.num_image_tokens:
            batch["img_embeds"] = torch.as_tensor(
                np.stack([r.img_embeds for r in chunk])).to(dev)
        with torch.no_grad():
            fwd = model.forward_logits(params, batch).float()
            pred = fwd[:, Lmax - 1: Lmax - 1 + new]  # predicts gen[:, j]
            top2 = torch.topk(pred, 2, dim=-1).values
            sure = (top2[..., 0] - top2[..., 1]) >= LM_GAP
            hit = pred.argmax(-1) == torch.as_tensor(gen).to(dev)
            checked += int(sure.sum())
            skipped += int((~sure).sum())
            bad += int((sure & ~hit).sum())
            pre = dict(batch, tokens=tokens[:, :Lmax])
            logits, cache = model.prefill(params, pre, cache_len)
            diff = max(diff, float((logits - pred[:, 0]).abs().max()))
            pos = torch.full((len(chunk),), Lmax + cfg.num_image_tokens,
                             device=dev)
            for j in range(new - 1):
                logits, cache = model.decode_step(
                    params, tokens[:, Lmax + j: Lmax + j + 1], pos + j, cache)
                diff = max(diff, float((logits - pred[:, j + 1]).abs().max()))
    return checked, skipped, bad, diff


def lm_serve(torch, eng, reqs):
    """(outputs, wall seconds) of one synchronised serve."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = eng.generate(reqs)
    torch.cuda.synchronize()
    return outs, time.perf_counter() - t0


def lm_recorded(eng, reqs):
    """(outputs, every logits tensor the engine sampled from, in order)."""
    seen = []
    sample = eng._sample
    eng._sample = lambda logits, *a: (seen.append(logits.clone()),
                                      sample(logits, *a))[1]
    try:
        return eng.generate(reqs), seen
    finally:
        del eng._sample


def lm_same_tokens(name, got, want):
    """Fail unless two serves generated the same tokens."""
    import numpy as np

    bad = [i for i, (g, w) in enumerate(zip(got, want))
           if not np.array_equal(g, w)]
    if bad or len(got) != len(want):
        fail(f"{name}: graphed tokens differ from eager in requests {bad}")


def lm_serve_checked(torch, dev, arch, cfg, params, reqs, B, cache_len,
                     card):
    """Serve ``reqs`` greedy on the graphed engine, then ``lm_check``: fails
    on any mismatch, and unless the eager engine's tokens are the same."""
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServeEngine

    model = Model(cfg)
    eng = ServeEngine(model, params, batch_size=B, cache_len=cache_len)
    outs, wall = lm_serve(torch, eng, reqs)
    captures = eng._prefill._cache_size() + eng._decode._cache_size()
    del eng
    eager = ServeEngine(model, params, batch_size=B, cache_len=cache_len,
                        cuda_graph=False)
    lm_same_tokens(f"lm[{arch}]", outs, eager.generate(reqs))
    n = sum(len(o) for o in outs)
    checked, skipped, bad, diff = lm_check(torch, dev, model, params, reqs,
                                           outs, B, cache_len)
    print(f"lm[{arch}]: {cfg.dtype} compute, {len(reqs)} requests x "
          f"{reqs[0].max_new_tokens} new tokens in {wall * 1e3:.1f} ms "
          f"({n / wall:.1f} tok/s, graphed, {captures} captures included) | "
          f"graphed tokens equal eager | greedy check: {checked} positions, "
          f"{bad} mismatches, {skipped} skipped (top-2 gap < {LM_GAP}) | "
          f"max |prefill/decode - forward| logits {diff:.3e} (ungated) | "
          f"on {card}")
    if bad or not checked:
        fail(f"lm[{arch}]: {bad} of {checked} generated tokens are not the "
             f"teacher-forced forward's argmax")
    return outs


def lm_step_ms(torch, prefill, decode, steps):
    """(ms of ``prefill()`` (median of 5, CUDA events), ms of each of
    ``steps`` greedy decode steps from its logits (CUDA events), the last
    token)."""
    prefill_ms = cuda_ms(prefill, reps=1, rounds=5)
    tok = prefill().argmax(-1)
    marks = []
    for _ in range(steps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        tok = decode(tok).argmax(-1)
        b.record()
        marks.append((a, b))
    torch.cuda.synchronize()
    return prefill_ms, [a.elapsed_time(b) for a, b in marks], tok


def lm_step_profile(torch, decode, tok):
    """One greedy step under ``set_sync_debug_mode("error")`` (a host read
    raises), then 2 traced steps: (device ms a step, device operations a
    step, busy share, traced ms)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tok = decode(tok).argmax(-1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            tok = decode(tok).argmax(-1)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    dev_ms, ops = per_call(torch, prof, 2)
    busy = sum(device_time_us(torch, prof).values()) / 1e3
    return dev_ms, ops, busy / traced_ms, traced_ms


def lm_full_width(torch, dev, card):
    """stablelm-1.6b at full width in its own dtypes (float32 params,
    bfloat16 compute): the eager engine, then the graphed one (a cold
    serve that captures, a warm serve that replays), gated equal token
    for token and logits for logits; their numbers; then the float32
    gate."""
    import dataclasses

    import numpy as np

    from repro_torch import configs
    from repro_torch.analysis.contracts import RecompileDetector
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServeEngine

    cfg = configs.get(LM_ARCH)
    model = Model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, dev)
    torch.cuda.synchronize()
    n_params = model.param_count()
    print(f"lm[{LM_ARCH}]: full width {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}: {n_params:,} params, "
          f"{n_params * 4 / 1e9:.2f} GB float32, drawn on the card in "
          f"{time.perf_counter() - t0:.2f} s")
    reqs = lm_requests(cfg, LM_REQUESTS, LM_NEW, SEED)
    batches = [reqs[s: s + LM_BATCH] for s in range(0, LM_REQUESTS, LM_BATCH)]
    # the signatures a cold serve sets up: a prefill per (B, Lmax), a
    # decode per B
    n_prefill = len({(len(c), max(len(r.prompt) for r in c))
                     for c in batches})
    n_decode = len({len(c) for c in batches})
    counted = lm_kernels()
    for fn in counted:
        fn.launches = 0
    from repro_torch.kernels.decode_attention import decode_attention as da
    da.launches = da.captured = da.fallbacks = 0

    # the eager engine (cuda_graph=False): the baseline
    torch.cuda.reset_peak_memory_stats()
    eager = ServeEngine(model, params, batch_size=LM_BATCH,
                        cache_len=LM_CACHE, cuda_graph=False)
    eager.generate(lm_requests(cfg, LM_BATCH, 2, SEED + 1))  # warm-up
    want, e_wall = lm_serve(torch, eager, reqs)
    e_peak = (torch.cuda.max_memory_allocated() / 1e9,
              torch.cuda.max_memory_reserved() / 1e9)

    # the graphed engine: a cold serve captures one graph a signature, a
    # warm serve only replays
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = ServeEngine(model, params, batch_size=LM_BATCH, cache_len=LM_CACHE)
    with RecompileDetector() as cold_det:
        cold_det.track("prefill", eng._prefill, allowed=n_prefill)
        cold_det.track("decode", eng._decode, allowed=n_decode)
        cold, c_wall = lm_serve(torch, eng, reqs)
    with RecompileDetector() as warm_det:
        warm_det.track("prefill", eng._prefill)
        warm_det.track("decode", eng._decode)
        warm, w_wall = lm_serve(torch, eng, reqs)
    g_peak = (torch.cuda.max_memory_allocated() / 1e9,
              torch.cuda.max_memory_reserved() / 1e9)
    grown = (cold_det.cache_growth("prefill"), cold_det.cache_growth("decode"))
    captures_s = eng._prefill.capture_s + eng._decode.capture_s
    if (grown != (n_prefill, n_decode) or cold_det.unexpected()
            or cold_det.backend_compiles != n_prefill + n_decode
            or len(captures_s) != n_prefill + n_decode):
        fail(f"lm[{LM_ARCH}]: the cold serve captured {grown} (prefill, "
             f"decode) for {n_prefill}, {n_decode} signatures: "
             f"{cold_det.report()}")
    if warm_det.unexpected() or warm_det.backend_compiles:
        fail(f"lm[{LM_ARCH}]: the warm serve captured again: "
             f"{warm_det.report()}")
    lm_same_tokens(f"lm[{LM_ARCH}] cold", cold, want)
    lm_same_tokens(f"lm[{LM_ARCH}] warm", warm, want)
    n_tok = sum(len(o) for o in warm)
    if [len(o) for o in warm] != [LM_NEW] * LM_REQUESTS:
        fail(f"lm[{LM_ARCH}]: generated lengths {[len(o) for o in warm]}")
    if not all(((o >= 0) & (o < cfg.vocab_size)).all() for o in warm):
        fail(f"lm[{LM_ARCH}]: a generated token outside the vocab")
    launched = {fn.__name__: fn.launches for fn in counted if fn.launches}
    if launched:
        fail(f"lm[{LM_ARCH}]: the LM path launched {launched}")
    # decode attention: the eager engine's steps and the graphed engine's
    # first call of its decode signature launch it, each capture records
    # it once a layer; no decode call falls back to attend_full
    da_counts = {"launches": da.launches, "captured": da.captured,
                 "fallbacks": da.fallbacks}
    if (da.captured != n_decode * cfg.num_layers or da.fallbacks
            or not da.launches):
        fail(f"lm[{LM_ARCH}]: decode attention counted {da_counts}, want "
             f"{n_decode * cfg.num_layers} captured and 0 fallbacks")

    # the first batch's logits: each replay against the eager call
    first = batches[0]
    g_out, g_logits = lm_recorded(eng, first)
    e_out, e_logits = lm_recorded(eager, first)
    lm_same_tokens(f"lm[{LM_ARCH}] first batch", g_out, e_out)
    differ = [i for i, (g, e) in enumerate(zip(g_logits, e_logits))
              if not torch.equal(g, e)]
    if differ or len(g_logits) != LM_NEW or len(e_logits) != LM_NEW:
        fail(f"lm[{LM_ARCH}]: replayed logits differ from eager at calls "
             f"{differ} (0 the prefill) of {len(g_logits)}")
    del g_logits, e_logits

    # prefill and decode steps of the first batch, by CUDA events: the
    # graphed engine's replays, then the eager engine's calls
    Lmax = max(len(r.prompt) for r in first)
    tokens = torch.as_tensor(np.stack([np.pad(r.prompt, (0, Lmax - len(r.prompt)))
                                       for r in first])).to(dev)
    with torch.no_grad():
        replays = eng._decode.replays
        g_pre, g_steps, tok = lm_step_ms(
            torch, lambda: eng._prefill({"tokens": tokens}), eng._decode,
            LM_NEW - 1)
        g_dev, g_ops, g_busy, g_traced = lm_step_profile(torch, eng._decode,
                                                         tok)
        if eng._decode.replays != replays + LM_NEW + 2:
            fail(f"lm[{LM_ARCH}]: timed decode steps were not replays")
        cache = {}
        pos = torch.full((LM_BATCH,), Lmax, dtype=torch.long, device=dev)

        def eager_prefill():
            logits, cache["c"] = model.prefill(params, {"tokens": tokens},
                                               LM_CACHE)
            pos.fill_(Lmax)
            return logits

        def eager_decode(tok):
            logits, cache["c"] = model.decode_step(params, tok[:, None], pos,
                                                   cache["c"])
            pos.add_(1)
            return logits

        e_pre, e_steps, tok = lm_step_ms(torch, eager_prefill, eager_decode,
                                         LM_NEW - 1)
        e_dev, e_ops, e_busy, e_traced = lm_step_profile(torch, eager_decode,
                                                         tok)
    del cache
    med = statistics.median
    print(f"lm[{LM_ARCH}]: served {LM_REQUESTS} requests (batch {LM_BATCH}, "
          f"cache {LM_CACHE}, prompts {min(len(r.prompt) for r in reqs)}-"
          f"{max(len(r.prompt) for r in reqs)} tokens) x {LM_NEW} new "
          f"tokens, greedy, bfloat16 compute: graphed warm {w_wall * 1e3:.1f}"
          f" ms, {n_tok / w_wall:.1f} tok/s; graphed cold (captures "
          f"included) {c_wall * 1e3:.1f} ms, {n_tok / c_wall:.1f} tok/s; "
          f"eager {e_wall * 1e3:.1f} ms, {n_tok / e_wall:.1f} tok/s | "
          f"tokens equal (cold, warm and eager) | on {card}")
    print(f"lm[{LM_ARCH}]: captures {n_prefill} prefill + {n_decode} decode "
          f"in the cold serve, 0 in the warm (RecompileDetector), each "
          f"{', '.join(f'{s * 1e3:.1f}' for s in captures_s)} ms | prefill "
          f"and {LM_NEW - 1} decode steps' logits of the first batch equal "
          f"eager bit for bit | on {card}")
    print(f"lm[{LM_ARCH}]: prefill graphed {g_pre:.3f} ms, eager "
          f"{e_pre:.3f} ms (batch {LM_BATCH} x {Lmax} tokens) | decode step "
          f"graphed median {med(g_steps):.3f} ms, spread {min(g_steps):.3f}-"
          f"{max(g_steps):.3f}; eager median {med(e_steps):.3f} ms, spread "
          f"{min(e_steps):.3f}-{max(e_steps):.3f} over {len(g_steps)} steps "
          f"each (CUDA events) | on {card}")
    for name, d, ops, busy, traced, steps in (
            ("graphed", g_dev, g_ops, g_busy, g_traced, g_steps),
            ("eager", e_dev, e_ops, e_busy, e_traced, e_steps)):
        if d is None:
            print(f"lm[{LM_ARCH}]: {name}: the profiler recorded no device "
                  f"time: device operations and busy share not measured")
        else:
            # untraced: a step's device time over its CUDA-event time
            print(f"lm[{LM_ARCH}]: {name} decode step: {ops} device "
                  f"operations, {d:.3f} ms of device time; busy "
                  f"{busy:.1%} of {traced:.3f} traced ms over 2 steps, "
                  f"{d / med(steps):.1%} of the untraced step's median | no "
                  f"host sync in a greedy step (sync debug mode) | on {card}")
    print(f"lm[{LM_ARCH}]: peak device memory graphed {g_peak[0]:.2f} GB "
          f"allocated, {g_peak[1]:.2f} GB reserved; eager {e_peak[0]:.2f} GB "
          f"allocated, {e_peak[1]:.2f} GB reserved | the six SNN kernels "
          f"launched 0 times | decode_attention {da_counts} (captured = "
          f"{n_decode} decode capture(s) x {cfg.num_layers} layers) | on "
          f"{card}")
    del eng, eager
    torch.cuda.empty_cache()

    # the gate: the same params in float32 compute.  TF32 stays off (main
    # sets it so) for every float32 result this phase gates
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("lm: TF32 is on; the float32 greedy check needs it off")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    lm_serve_checked(torch, dev, LM_ARCH, cfg32, params, reqs, LM_BATCH,
                     LM_CACHE, card)
    print(f"lm[{LM_ARCH}]: peak device memory (float32 gate) "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB | float32 "
          f"decode calls sent to attend_full: {da.fallbacks} | on {card}")
    return da_counts


# the LM serving cell's decode step (portbench lm-batch-b32-p1024-n256 on
# stablelm-1.6b): B 32, a cache of 1,280 rows, 32 kv heads of 64, one query
# group; 1,152 valid rows a row, the mean over a batch's 255 steps
DA_SHAPE = dict(B=32, S=1280, Kv=32, G=1, D=64)
DA_VALID = 1152


def lm_decode_attention(torch, dev, card):
    """The decode-attention kernel alone at the serving cell's shape: its
    device time a launch (``torch.profiler``) beside its bytes bound (the
    valid K and V rows once), the plain version (``attend_full`` as
    ``gqa_decode`` called it) and ``F.scaled_dot_product_attention`` over
    the same rows, the library yardstick, timed only (the port never calls
    it).  Gated: within the card test's tolerance of ``attend_full``."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.attention import attend_full

    B, S, Kv, G, D = (DA_SHAPE[k] for k in ("B", "S", "Kv", "G", "D"))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
               for shape in ((B, 1, Kv, G, D), (B, S, Kv, D), (B, S, Kv, D)))
    pos = torch.full((B,), DA_VALID - 1, dtype=torch.long, device=dev)
    scale = D ** -0.5
    j = torch.arange(S, device=dev)[None, :]
    kv_pos = torch.where(j <= pos[:, None], j, -1)

    def kernel():
        return da.decode_attention(q, k, v, pos, scale)

    def plain():
        return attend_full(q, k, v, pos[:, None], kv_pos, window=None,
                           scale=scale)

    # SDPA's (B, heads, L, D) layout: a view of the cache, no copy timed
    qs = q.reshape(B, 1, Kv * G, D).transpose(1, 2)
    ks, vs = k.transpose(1, 2), v.transpose(1, 2)
    keep = (j <= pos[:, None])[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=keep,
                                              scale=scale)

    got, want = kernel(), plain()
    err = (got.float() - want.float()).abs()
    ulp = torch.exp2(torch.floor(torch.log2(
        want.abs().float().clamp_min(2.0 ** -126))) - 7)
    within = float((err <= ulp).float().mean())
    lib_err = float((library().transpose(1, 2).reshape(got.shape).float()
                     - want.float()).abs().max())
    if within < 0.99:
        fail(f"decode_attention: {within:.4%} of outputs within 1 bf16 ulp "
             f"of attend_full (needs 99 %)")
    ms = device_ms(kernel, reps=50, only="decode_attention_kernel")
    call_ms = device_ms(kernel, reps=50)
    plain_ms = device_ms(plain, reps=10)
    library_ms = device_ms(library, reps=50)
    ev_ms = cuda_ms(kernel, reps=50)
    nbytes = da.bytes_bound([DA_VALID - 1] * B, S, Kv, D)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    share = None if ms is None else bound_ms / ms
    print(f"decode_attention: B {B}, S {S}, Kv {Kv}, G {G}, D {D}, "
          f"{DA_VALID} valid rows a row | kernel {ms} ms device a launch "
          f"(call {call_ms} ms; {ev_ms:.4f} ms CUDA events) | bound "
          f"{bound_ms:.4f} ms ({nbytes / 1e6:.1f} MB at 3.35 TB/s) = "
          f"{share if share is None else f'{share:.1%}'} of the bound | "
          f"plain attend_full {plain_ms} ms | library SDPA {library_ms} ms "
          f"(timed only; max |SDPA - attend_full| {lib_err:.3e}) | "
          f"{within:.4%} of outputs within 1 bf16 ulp of attend_full, max "
          f"|diff| {float(err.max()):.3e} | on {card}")
    return {"ms": ms, "call_ms": call_ms, "events_ms": ev_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "plain_ms": plain_ms,
            "library_ms": library_ms, "within_1ulp": within,
            "max_abs_err": float(err.max())}


# the DeepSeek serving cell's decode step (portbench lm-batch-b128-p1024-n512
# on deepseek-v2-lite): B 128, a cache of 1,536 rows, 16 heads of rank 512
# and rope 64; 1,280 valid rows a row, the mean over a batch's 511 steps
MLA_SHAPE = dict(B=128, S=1536, H=16)
MLA_VALID = 1280
MLA_COPIES = 4  # caches the timed calls take in turn: 905 MB, past the L2


def lm_mla_decode(torch, dev, card):
    """The absorbed-MLA decode kernel alone at the DeepSeek serving cell's
    shape: its device time a launch (``torch.profiler``, 50 calls, each on
    the next of MLA_COPIES caches, so each reads its rows cold as a decode
    step does) beside its bytes bound (the valid c_kv and k_rope rows once),
    the bound of a design that reads c_kv twice, and the plain version
    (``_mla_latent`` as ``mla_decode`` called it).  Gated: within the card
    test's tolerance of the plain version."""
    from repro_torch.kernels import mla_decode as mk
    from repro_torch.models.attention import _mla_latent

    B, S, H = (MLA_SHAPE[k] for k in ("B", "S", "H"))
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def bf16(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    q, q_rope = bf16(B, 1, H, 512), bf16(B, 1, H, 64)
    caches = [(bf16(B, S, 512), bf16(B, S, 64)) for _ in range(MLA_COPIES)]
    pos = torch.full((B,), MLA_VALID - 1, dtype=torch.long, device=dev)
    scale = 192 ** -0.5
    j = torch.arange(S, device=dev)[None, :]
    kv_pos = torch.where(j <= pos[:, None], j, -1)
    turn = [0]

    def kernel():
        c_kv, k_rope = caches[turn[0] % MLA_COPIES]
        turn[0] += 1
        return mk.mla_decode(q, q_rope, c_kv, k_rope, pos, scale)

    def plain():
        c_kv, k_rope = caches[0]
        return _mla_latent(q, q_rope, c_kv, k_rope, pos[:, None], kv_pos,
                           scale)

    got, want = kernel(), plain()
    err = (got.float() - want.float()).abs()
    ulp = torch.exp2(torch.floor(torch.log2(
        want.abs().float().clamp_min(2.0 ** -126))) - 7)
    within = float((err <= ulp).float().mean())
    if within < 0.99:
        fail(f"mla_decode: {within:.4%} of outputs within 1 bf16 ulp of "
             f"_mla_latent (needs 99 %)")
    ms = device_ms(kernel, reps=50, only="mla_decode_kernel")
    call_ms = device_ms(kernel, reps=50)
    plain_ms = device_ms(plain, reps=10)
    ev_ms = cuda_ms(kernel, reps=50)
    valid = [MLA_VALID - 1] * B
    bound_ms = mk.bytes_bound(valid, S) / HBM_BYTES_PER_S * 1e3
    two_ms = mk.bytes_two_reads(valid, S) / HBM_BYTES_PER_S * 1e3
    share = None if ms is None else bound_ms / ms
    print(f"mla_decode: B {B}, S {S}, H {H}, rank 512, rope 64, {MLA_VALID} "
          f"valid rows a row, {MLA_COPIES} caches in turn | kernel {ms} ms "
          f"device a launch (call {call_ms} ms; {ev_ms:.4f} ms CUDA events) "
          f"| one-read bound {bound_ms:.4f} ms "
          f"({mk.bytes_bound(valid, S) / 1e6:.1f} MB at 3.35 TB/s) = "
          f"{share if share is None else f'{share:.1%}'} of it; two-read "
          f"bound {two_ms:.4f} ms | plain _mla_latent {plain_ms} ms | "
          f"{within:.4%} of outputs within 1 bf16 ulp of it, max |diff| "
          f"{float(err.max()):.3e} | on {card}")
    del caches
    return {"ms": ms, "call_ms": call_ms, "events_ms": ev_ms,
            "bound_ms": bound_ms, "bound_two_reads_ms": two_ms,
            "bound_by": "bytes", "plain_ms": plain_ms, "library_ms": None,
            "within_1ulp": within, "max_abs_err": float(err.max())}


def phase_lm(torch, dev, card):
    """Phase 11: the LM zoo's serving path (``ServeEngine`` on ``Model``);
    returns the decode-attention and MLA decode kernels' rows."""
    import dataclasses
    import io
    from contextlib import redirect_stdout

    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.serving.engine import ServeEngine

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    da_row = lm_decode_attention(torch, dev, card)
    torch.cuda.empty_cache()
    mla_row = lm_mla_decode(torch, dev, card)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    da_row["launches"] = lm_full_width(torch, dev, card)
    torch.cuda.empty_cache()

    # the other families at full width, float32 compute, 2 requests x 4
    for arch in LM_FAMILIES:
        cfg = dataclasses.replace(configs.get(arch), dtype="float32")
        note = ""
        if cfg.num_experts:
            # a forward and a decode group their tokens differently: with
            # drops their logits differ by design, so none is dropped
            cfg = dataclasses.replace(cfg, capacity_factor=100.0,
                                      moe_group_size=16)
            note = " (capacity_factor 100, moe_group_size 16: no drops)"
        cache_len = cfg.num_image_tokens + LM_CACHE
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        params = Model(cfg).init(SEED, dev)
        torch.cuda.synchronize()
        print(f"lm[{arch}]: full width, {Model(cfg).param_count():,} params "
              f"drawn in {time.perf_counter() - t0:.2f} s{note}")
        lm_serve_checked(torch, dev, arch, cfg, params,
                         lm_requests(cfg, 2, 4, SEED), 2, cache_len, card)
        print(f"lm[{arch}]: peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        del params
        torch.cuda.empty_cache()
    for arch in configs.ARCH_IDS:
        if arch not in LM_FAMILIES and arch != LM_ARCH:
            gb = Model(configs.get(arch)).param_count() * 4 / 1e9
            why = ("its float32 params exceed the card" if gb > 60 else
                   f"the dense family runs at full width as {LM_ARCH}")
            print(f"lm[{arch}]: reduced only: {why} ({gb:.1f} GB float32)")

    # all ten archs at reduced size: decode consistency, then the launcher
    import numpy as np

    for arch in configs.ARCH_IDS:
        cfg = configs.get(arch).reduced()
        if cfg.num_experts:
            cfg = dataclasses.replace(cfg, capacity_factor=100.0,
                                      moe_group_size=16)
        model = Model(cfg)
        params = model.init(SEED, dev)
        rng = np.random.default_rng(SEED)
        shape = (2, 20, cfg.num_codebooks) if cfg.num_codebooks else (2, 20)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, shape)).to(dev)
        batch = {"tokens": toks}
        if cfg.num_image_tokens:
            batch["img_embeds"] = torch.as_tensor(rng.normal(
                0, 1, (2, cfg.num_image_tokens, 1024)).astype(np.float32)
            ).to(dev)
        with torch.no_grad():
            full = model.forward_logits(params, batch)
            logits, cache = model.prefill(params, dict(batch,
                                                       tokens=toks[:, :16]),
                                          20 + cfg.num_image_tokens + 8)
            errs = [float((logits - full[:, 15]).abs().max())]
            for s in range(16, 20):
                pos = torch.full((2,), s + cfg.num_image_tokens, device=dev)
                logits, cache = model.decode_step(params, toks[:, s: s + 1],
                                                  pos, cache)
                errs.append(float((logits - full[:, s]).abs().max()))
        if max(errs) >= 5e-4:
            fail(f"lm reduced {arch}: prefill + decode off the forward by "
                 f"{max(errs):.3e}")
        # graphed against eager on the launcher's requests: greedy, and
        # sampled on one seed for stablelm (the launcher's q115 run)
        cases = [(cfg, 0.0)]
        if arch == LM_ARCH:
            cases.append((dataclasses.replace(cfg, quant="q115"), 0.8))
        for c, temp in cases:
            reqs = serve.lm_requests(c, 3, 4, temp, seed=SEED)
            cache_len = 64 + c.num_image_tokens
            got = ServeEngine(Model(c), params, 2, cache_len,
                              seed=SEED).generate(reqs)
            want = ServeEngine(Model(c), params, 2, cache_len, seed=SEED,
                               cuda_graph=False).generate(reqs)
            lm_same_tokens(f"lm reduced[{arch}] temperature {temp}", got,
                           want)
        argv = ["--arch", arch, "--requests", "3", "--new-tokens", "4",
                "--batch", "2"]
        if arch == LM_ARCH:
            argv += ["--temperature", "0.8", "--quant", "q115"]
        out = io.StringIO()
        with redirect_stdout(out):
            serve.main(argv)
        line = out.getvalue().strip()
        if f"{arch}: served 3 reqs / 12 tokens" not in line:
            fail(f"lm reduced {arch}: launcher printed {line!r}")
        print(f"lm reduced[{arch}]: prefill + decode within "
              f"{max(errs):.2e} of the forward (gate 5e-4) | graphed tokens "
              f"equal eager ({', '.join(f'temperature {t}' for _, t in cases)}"
              f") | launcher (graphed): {line}")
    # the quantized-LM example, graphed by default as the launcher
    from repro_torch.examples import serve_quantized_lm

    out = io.StringIO()
    with redirect_stdout(out):
        serve_quantized_lm.main(["--q115", "--requests", "3",
                                 "--new-tokens", "4"])
    lines = [ln for ln in out.getvalue().splitlines() if "served" in ln]
    if not lines or "served 3 requests, 12 new tokens" not in lines[0]:
        fail(f"lm example: serve_quantized_lm printed {out.getvalue()!r}")
    print(f"lm example (graphed): {lines[0].strip()}")
    print(f"lm: phase 11 took {time.perf_counter() - t_phase:.1f} s | on "
          f"{card}")
    return da_row, mla_row


# --------------------------------------------------------------------------
# Phase 12: the LM zoo's training path
# --------------------------------------------------------------------------
LM_TRAIN_BATCH, LM_TRAIN_SEQ, LM_TRAIN_STEPS, LM_TRAIN_CHECK = 4, 128, 12, 3
# device kernels that are matrix products (cuBLAS, CUTLASS), by name
LM_MATMUL_NAMES = ("gemm", "nvjet", "xmma", "cutlass", "cublas")


def lm_kernels():
    """The six kernels of the table: the LM path launches none of them."""
    from repro_torch.kernels import aer_matmul, lif_fused, q115_matmul
    from repro_torch.kernels import snn_chunk, spike_matmul

    return (snn_chunk.snn_chunk, aer_matmul.aer_spike_matmul_batched,
            aer_matmul.aer_spike_matmul, lif_fused.lif_fused,
            spike_matmul.spike_matmul, q115_matmul.q115_matmul)


def lm_trainer(cfg, dev, jit=True):
    """The launcher's trainer: ``Trainer(Model(cfg), lm_optimizer)`` with
    its defaults (``jit=True, donate=True``) unless ``jit=False``."""
    from repro_torch.launch.train import lm_optimizer
    from repro_torch.models.model import Model
    from repro_torch.train.loop import Trainer

    return Trainer(Model(cfg, dev), lm_optimizer(3e-4, LM_TRAIN_STEPS),
                   jit=jit)


def lm_batches(cfg, dev):
    from repro_torch.launch.train import batches

    return batches(cfg, LM_TRAIN_BATCH, LM_TRAIN_SEQ, dev)


def lm_train_full_width(torch, dev, card):
    """(a) stablelm-1.6b at full width and depth in its own dtypes, the
    launcher's trainer and batches, each step a graph replay; then (c)
    one eager step under sync-debug mode."""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import configs
    from repro_torch.optim.adam import update_into
    from repro_torch.train.loop import StaticStep
    from repro_torch.tree import tree_leaves

    cfg = configs.get(LM_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    total = torch.cuda.get_device_properties(dev).total_memory
    tr = lm_trainer(cfg, dev)
    if not isinstance(tr.step_fn, StaticStep) or not tr.step_fn.donate:
        fail("the LM trainer's default step is not the donated static step")
    t0 = time.perf_counter()
    state = tr.init_state(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = tr.model.param_count()
    batches = lm_batches(cfg, dev)
    pre = [next(batches) for _ in range(LM_TRAIN_STEPS + 3)]
    torch.cuda.synchronize()

    # the main path: counts from 0, read right after
    counted = lm_kernels()
    for fn in counted:
        fn.launches = 0
    losses, marks = [], []
    t0 = time.perf_counter()
    state, m = tr.step_fn(state, pre[0])  # warm-up and capture, then replay
    losses.append(m["loss"])
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    for b in pre[1:LM_TRAIN_STEPS]:
        a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        state, m = tr.step_fn(state, b)
        e.record()
        marks.append((a, e))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    launched = {fn.__name__: fn.launches for fn in counted if fn.launches}
    step = tr.step_fn
    ms = [a.elapsed_time(e) for a, e in marks]
    losses = [float(x) for x in losses]
    peak, reserved = (torch.cuda.max_memory_allocated(),
                      torch.cuda.max_memory_reserved())
    if launched:
        fail(f"lm train: the LM path launched {launched}")
    if step.captures != 1 or step.replays != LM_TRAIN_STEPS:
        fail(f"lm train: {step.captures} captures, {step.replays} replays "
             f"for {LM_TRAIN_STEPS} steps (want 1 and {LM_TRAIN_STEPS})")
    if not all(math.isfinite(x) for x in losses):
        fail(f"lm train: losses {losses}")
    if peak >= total:
        fail(f"lm train: peak {peak} B not under the card's {total} B")
    med = statistics.median(ms)
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    print(f"lm train[{LM_ARCH}]: full width and depth ({cfg.num_layers} "
          f"layers, d_model {cfg.d_model}, vocab {cfg.vocab_size}; "
          f"{n_params:,} float32 params, {cfg.dtype} compute, remat "
          f"{cfg.remat}), batch {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens, "
          f"the launcher's AdamW chain and Markov batches; params drawn in "
          f"{init_s:.2f} s | on {card}")
    print(f"lm train[{LM_ARCH}]: {LM_TRAIN_STEPS} steps, captures "
          f"{step.captures}, graph replays {step.replays}; first step (warm-up "
          f"+ capture + replay) {first_s:.2f} s | step median {med:.3f} ms, "
          f"spread {min(ms):.3f}-{max(ms):.3f} over {len(ms)} replays (CUDA "
          f"events), {tokens / med * 1e3:.1f} tokens/s | loss {losses[0]:.4f}"
          f" -> {losses[-1]:.4f}, all finite | the six SNN kernels launched "
          f"0 times | on {card}")
    print(f"lm train[{LM_ARCH}]: peak allocated {peak / 1e9:.2f} GB, peak "
          f"reserved {reserved / 1e9:.2f} GB of {total / 1e9:.2f} GB | on "
          f"{card}")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in pre[LM_TRAIN_STEPS:LM_TRAIN_STEPS + 2]:
            state, _ = tr.step_fn(state, b)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    dev_ms, ops = per_call(torch, prof, 2)
    if dev_ms is None:
        print(f"lm train[{LM_ARCH}]: the profiler recorded no device time: "
              f"device operations and busy share not measured")
    else:
        by = device_time_us(torch, prof)
        busy = sum(by.values()) / 1e3
        mm = sum(v for k, v in by.items() if any(
            w in k.lower() for w in LM_MATMUL_NAMES)) / 2e3
        print(f"lm train[{LM_ARCH}]: a step runs {ops} device operations, "
              f"{dev_ms:.3f} ms of device time, of which matmul kernels "
              f"{mm:.3f} ms; busy {busy:.3f} of {traced_ms:.3f} traced ms "
              f"over 2 steps ({busy / traced_ms:.1%}) | on {card}")
    # the optimizer's part alone: clip, AdamW and apply over the 18 leaves
    # on gradients the size of the params, written into the state's own
    # buffers as the step writes them (the state is dropped after this);
    # then with its results dropped, which leaves out the copies into them
    grads = [torch.full_like(p, 1e-4) for p in tree_leaves(state.params)]
    bufs = (state.params, state.opt_state)
    opt_ms = cuda_ms(lambda: update_into(tr.optimizer, list(grads),
                                         state.opt_state, state.params, bufs),
                     reps=1, rounds=3)
    opt_drop_ms = cuda_ms(lambda: update_into(tr.optimizer, list(grads),
                                              state.opt_state, state.params,
                                              None),
                          reps=1, rounds=3)
    print(f"lm train[{LM_ARCH}]: the optimizer's leaf-by-leaf step alone "
          f"(global norm, clip, AdamW, apply) {opt_ms:.3f} ms written into "
          f"the state's buffers, {opt_drop_ms:.3f} ms with its results "
          f"dropped: the copies into params, mu and nu cost "
          f"{opt_ms - opt_drop_ms:.3f} ms (CUDA events) | on {card}")
    out = {"ms": med, "peak": peak, "reserved": reserved, "opt_ms": opt_ms,
           "opt_drop_ms": opt_drop_ms}
    del tr, step, state, pre, m, grads, bufs  # the graph, its pool, the buffers
    gc.collect()
    torch.cuda.empty_cache()

    # the same step without remat: what the recompute costs
    torch.cuda.reset_peak_memory_stats()
    tr = lm_trainer(dataclasses.replace(cfg, remat="none"), dev)
    state = tr.init_state(SEED)
    batches = lm_batches(cfg, dev)
    state, _ = tr.step_fn(state, next(batches))
    rest = [next(batches) for _ in range(5)]
    torch.cuda.synchronize()
    marks = []
    for b in rest:
        a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        state, _ = tr.step_fn(state, b)
        e.record()
        marks.append((a, e))
    torch.cuda.synchronize()
    ms0 = [a.elapsed_time(e) for a, e in marks]
    if (tr.step_fn.captures, tr.step_fn.replays) != (1, 6):
        fail(f"lm train: remat none ran {tr.step_fn.captures} captures, "
             f"{tr.step_fn.replays} replays")
    out["ms_no_remat"] = statistics.median(ms0)
    print(f"lm train[{LM_ARCH}]: remat none, the same step: median "
          f"{out['ms_no_remat']:.3f} ms, spread {min(ms0):.3f}-{max(ms0):.3f}"
          f" over {len(ms0)} replays; peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB | remat full "
          f"costs {med - out['ms_no_remat']:.3f} ms a step | on {card}")
    del tr, state
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the eager step reads the host nowhere
    torch.cuda.reset_peak_memory_stats()
    tr = lm_trainer(cfg, dev, jit=False)
    state = tr.init_state(SEED)
    batch = next(lm_batches(cfg, dev))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, m = tr.step_fn(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    loss = float(m["loss"])
    if not math.isfinite(loss):
        fail(f"lm train: the eager step's loss is {loss}")
    print(f"lm train[{LM_ARCH}]: an eager full-width step passes "
          f"set_sync_debug_mode('error') (loss {loss:.4f}); peak allocated "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB | on {card}")
    del tr, state, m
    gc.collect()
    torch.cuda.empty_cache()
    return out


def lm_graph_equals_eager(torch, dev, arch, card, quant=None):
    """(b) ``arch`` at full width, one repeat of its layer group, float32
    compute (``quant``: the launcher's ``--quant``): 3 graphed steps
    against 3 eager ones from the same params and batches, bit for bit."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.tree import tree_leaves, tree_map

    cfg = configs.get(arch)
    depth = len(transformer.layer_plan(cfg)[0][1])
    cfg = dataclasses.replace(cfg, dtype="float32", num_layers=depth,
                              quant=quant)
    if quant:
        arch = f"{arch}, quant {quant}"
    runs = []
    for jit in (True, False):
        torch.cuda.reset_peak_memory_stats()
        tr = lm_trainer(cfg, dev, jit=jit)
        state = tr.init_state(SEED)
        batches = lm_batches(cfg, dev)
        losses = []
        for _ in range(LM_TRAIN_CHECK):
            state, m = tr.step_fn(state, next(batches))
            losses.append(m["loss"].clone())
        torch.cuda.synchronize()
        graphs = ((tr.step_fn.captures, tr.step_fn.replays) if jit else None)
        runs.append((tree_map(torch.clone, (state.params, state.opt_state)),
                     losses, graphs, torch.cuda.max_memory_allocated()))
        del tr, state, m
        gc.collect()
        torch.cuda.empty_cache()
    (gs, gl, graphs, gpeak), (es, el, _, epeak) = runs
    if graphs != (1, LM_TRAIN_CHECK):
        fail(f"lm train check[{arch}]: captures, replays {graphs}")
    pairs = list(zip(tree_leaves(gs), tree_leaves(es)))
    bad = sum(not torch.equal(a, b) for a, b in pairs)
    if bad or not all(torch.equal(a, b) for a, b in zip(gl, el)):
        fail(f"lm train check[{arch}]: graphed and eager differ in {bad} of "
             f"{len(pairs)} state leaves, losses {[float(x) for x in gl]} "
             f"against {[float(x) for x in el]}")
    if not all(math.isfinite(float(x)) for x in gl):
        fail(f"lm train check[{arch}]: losses {[float(x) for x in gl]}")
    print(f"lm train check[{arch}]: full width, {depth} layer(s) (one repeat "
          f"of its group), float32 compute, remat {cfg.remat}: "
          f"{LM_TRAIN_CHECK} graphed steps (1 capture, {LM_TRAIN_CHECK} "
          f"replays) equal {LM_TRAIN_CHECK} eager steps bit for bit: "
          f"{len(pairs)} params and Adam leaves, losses "
          f"{' '.join(f'{float(x):.4f}' for x in gl)} | peak "
          f"{gpeak / 1e9:.2f} GB graphed, {epeak / 1e9:.2f} GB eager | on "
          f"{card}")


def phase_lm_train(torch, dev, card):
    """Phase 12: the LM zoo's training path (``Model.loss`` under the
    launcher's graphed ``Trainer``)."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        fail("lm train: TF32 is on; the float32 checks need it off")
    t0 = time.perf_counter()
    full = lm_train_full_width(torch, dev, card)
    for arch in (LM_ARCH,) + LM_FAMILIES:
        lm_graph_equals_eager(torch, dev, arch, card)
    lm_graph_equals_eager(torch, dev, LM_ARCH, card, quant="q115")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", LM_ARCH,
         "--reduced", "--steps", "3"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    lines = out.stdout.strip().splitlines()
    if (out.returncode != 0 or not any(ln.startswith("final: ") for ln in lines)
            or "captures 1, graph replays 3" not in lines[-1]):
        fail(f"lm train: the launcher exited {out.returncode}: "
             f"{out.stdout[-2000:]} {out.stderr[-2000:]}")
    print(f"lm train launcher: python -m repro_torch.launch.train --arch "
          f"{LM_ARCH} --reduced --steps 3 | {lines[0]} | "
          f"{[ln for ln in lines if ln.startswith('final: ')][0]} | "
          f"{lines[-1]}")
    print(f"lm train: phase 12 took {time.perf_counter() - t0:.1f} s | on "
          f"{card}")
    return full


def phase_sharded(torch, dev, params_np, card, main_run):
    """Phase 14: the engine's slot sharding (``mesh=``) at full width on
    one card, a mesh of ``cuda:0`` repeated, held against the unsharded
    graph engine; the elastic snapshot; the GPipe pipeline."""
    import shutil

    import numpy as np

    from repro_torch.configs.collision_snn import CONFIG
    from repro_torch.core import snn
    from repro_torch.distributed.partitioning import Mesh
    from repro_torch.distributed.pipeline import pipeline_forward
    from repro_torch.serving.snn_engine import SNNStreamEngine

    t_phase = time.perf_counter()
    params = snn.params_from_numpy(params_np, dev)
    img_reqs, spike_reqs = main_requests()
    reqs = img_reqs + spike_reqs
    here = torch.device("cuda", torch.cuda.current_device())

    def engine(shards):
        return SNNStreamEngine(
            params, CONFIG, num_slots=SLOTS, chunk_steps=TC, backend="fused",
            device=dev,
            mesh=None if shards == 1 else Mesh([here] * shards, ("data",)))

    def fields(r):  # every field but the clocks
        return (r.request_id, r.prediction, r.steps, r.spike_rate,
                r.energy_pj, r.spike_counts.tolist(),
                r.events_per_layer.tolist(), r.disposition, r.fault,
                r.parked, r.deadline_missed)

    sigs = {("spikes" if r.spikes is not None else "image",
             r.num_steps or CONFIG.num_steps) for r in reqs}
    n_img = len(img_reqs)
    want, launches = None, {}
    for shards in (1, 2, 4):
        name = f"sharded[{shards} shard{'s' if shards > 1 else ''}]"
        eng = engine(shards)
        results, wall, eager = serve_counted(torch, eng, reqs)
        ticks, per = eng.dispatched_ticks, eng.graph_launches_per_replay
        if len(eng._shards) != shards or not eng.graphed or per != 1:
            fail(f"{name}: {len(eng._shards)} shards, graphed {eng.graphed}, "
                 f"{per} snn_chunk launch(es) a replay")
        if eng.graph_replays != shards * ticks:
            fail(f"{name}: {eng.graph_replays} replays for {ticks} ticks")
        if not eager == eng.graph_captures == shards:
            fail(f"{name}: {eng.graph_captures} tick captures and {eager} "
                 f"warm-up launches; one a shard expected")
        launches[shards] = eager + per * eng.graph_replays
        if launches[shards] != shards * ticks + shards:
            fail(f"{name}: {launches[shards]} snn_chunk launches != "
                 f"{shards} x {ticks} ticks + {shards} warm-ups")
        by_shard = collections.defaultdict(set)
        for i, kind, T, _ in eng._admit_signatures:
            by_shard[i].add((kind, T))
        if (eng.admit_captures != len(eng._admit_signatures)
                or sorted(by_shard) != list(range(shards))
                or set().union(*by_shard.values()) != sigs):
            fail(f"{name}: {eng.admit_captures} admission captures of "
                 f"{len(eng._admit_signatures)} (shard, kind, T) signatures "
                 f"over shards {sorted(by_shard)}")
        if eng.steady_state_recompiles():
            fail(f"{name}: {eng.steady_state_recompiles()} re-captures")
        check_no_retries(name, eng)
        got = [fields(r) for r in results]
        if want is None:
            want = got  # the unsharded graph engine
        elif got != want:
            bad = [a[0] for a, b in zip(got, want) if a != b]
            fail(f"{name}: requests {bad} differ from the unsharded engine")
        captures = (eng.graph_captures, eng.admit_captures)
        replays = eng.graph_replays
        again, wall2, _ = serve_counted(torch, eng, reqs)
        if ((eng.graph_captures, eng.admit_captures) != captures
                or eng.steady_state_recompiles()):
            fail(f"{name}: a second serve captured: {captures} -> "
                 f"{(eng.graph_captures, eng.admit_captures)}")
        if [fields(r)[1:] for r in again[n_img:]] != [
                a[1:] for a in want[n_img:]]:
            fail(f"{name}: the second serve differs on spike requests")
        print(f"{name}: {len(results)} requests equal the unsharded graph "
              f"engine in every field | {ticks} ticks, {replays} "
              f"replays ({shards} a tick) + {eager} warm-up = "
              f"{launches[shards]} snn_chunk launches | captures: {shards} "
              f"tick, {eng.admit_captures} admission over "
              f"{len(sigs)} (kind, T); a second serve 0 | "
              f"{wall / ticks * 1e3:.3f} ms/tick cold, "
              f"{wall2 / (eng.dispatched_ticks - ticks) * 1e3:.3f} captured "
              f"| on {card}")

    spread = {1: [], 2: [], 4: []}
    phases = {1: [], 2: [], 4: []}  # a captured serve's tick_breakdown
    for shards in (4, 2, 1, 1, 2, 4, 2, 4, 1):
        eng = engine(shards)
        serve_counted(torch, eng, reqs)
        ticks = eng.dispatched_ticks
        eng.reset_tick_stats()
        wall = serve_counted(torch, eng, reqs)[1]
        spread[shards].append(round(wall / (eng.dispatched_ticks - ticks)
                                    * 1e3, 3))
        tb = eng.tick_breakdown()
        phases[shards].append([round(tb[k], 1) for k in (
            "host_prep_us", "dispatch_us", "stats_fetch_us")])
    print(f"sharded: ms/tick of a captured serve (48 requests), three runs "
          f"each in turns, not gated: {json.dumps(spread)} | phase 4's "
          f"captured serve {main_run['ms_tick_captured']:.3f} ms/tick (PR 21: "
          f"0.778-1.156) | on {card}")
    print(f"sharded: the same serves' mean tick in us [host_prep, dispatch "
          f"(the shards' replays and stats copies), stats_fetch]: "
          f"{json.dumps(phases)} | on {card}")

    # a snapshot taken mid-serve on 2 shards restores into 1 and 4
    snap_root = ROOT / "build" / "smoke_snapshots"
    shutil.rmtree(snap_root, ignore_errors=True)
    src = engine(2)
    for r in reqs:
        src.submit(r)
    early = []
    for _ in range(6):
        early += src.poll()
    resident = sum(r is not None for r in src._slot_req)
    path = src.snapshot(str(snap_root / "sharded"))
    whole = {a[0]: a for a in want}
    for shards in (1, 4):
        dst = engine(shards)
        dst.restore(path)
        got = {r.request_id: fields(r) for r in early + dst.drain()}
        if got != whole:
            bad = sorted(k for k in whole if got.get(k) != whole[k])
            fail(f"sharded snapshot 2 -> {shards}: requests {bad} differ from "
                 f"the uninterrupted run")
        check_no_retries(f"sharded snapshot 2 -> {shards}", dst)
    shutil.rmtree(snap_root, ignore_errors=True)
    print(f"sharded: a snapshot after 6 ticks on 2 shards ({resident} "
          f"windows resident, {len(early)} delivered) restored into 1 and 4 "
          f"shards: both finish equal to the uninterrupted run in every "
          f"field | on {card}")
    try:
        SNNStreamEngine(params, CONFIG, num_slots=3, chunk_steps=TC,
                        backend="fused", mesh=Mesh([here] * 2, ("data",)))
    except ValueError as err:
        if "num_slots=3" not in str(err):
            fail(f"sharded: 3 slots over 2 shards raised without naming "
                 f"num_slots: {err}")
    else:
        fail("sharded: 3 slots over 2 shards did not raise")
    print("sharded: 3 slots over 2 shards raise ValueError naming num_slots")

    # GPipe over a 4-stage mesh of the card, against the composition
    S, M, mb, d = 4, 8, 4, 2048
    rng = np.random.default_rng(SEED + 14)
    w = torch.from_numpy(rng.normal(0, d ** -0.5, (S, d, d)).astype(
        np.float32)).to(dev)
    xs = torch.from_numpy(rng.normal(0, 1, (M, mb, d)).astype(
        np.float32)).to(dev)
    pipe = pipeline_forward(lambda p, x: torch.tanh(x @ p),
                            Mesh([here] * S, ("pipe",)), "pipe")
    got = pipe(w, xs)

    def compose(x):
        for s in range(S):
            x = torch.tanh(x @ w[s])
        return x

    ref = torch.stack([compose(xs[m]) for m in range(M)])
    err = float((got - ref).abs().max())
    if got.shape != xs.shape or not err <= 1e-5:
        fail(f"pipeline: {tuple(got.shape)}, max abs error {err} from the "
             f"sequential composition (limit 1e-5)")
    print(f"pipeline: {S} stages on a mesh of {here} x {S}, {M} microbatches "
          f"of {mb} x {d}, tanh(x @ w) float32 (TF32 off): max abs error "
          f"{err:.3g} from the sequential composition (limit 1e-5) | "
          f"phase 14 took {time.perf_counter() - t_phase:.1f} s | on {card}")
    return {"launches": {str(k): v for k, v in launches.items() if k > 1},
            "ms_tick": spread}


# --------------------------------------------------------------------------
# Phase 15: the dry run (every tensor on meta) and its plan on the card
# --------------------------------------------------------------------------
DRYRUN_CELLS = (("stablelm-1.6b", "train_4k"), ("stablelm-1.6b", "prefill_32k"),
                ("stablelm-1.6b", "decode_32k"), ("mixtral-8x7b", "long_500k"))
PLAN_BAND = 0.15  # planned peak against the card's, relative


def dryrun_cells(torch, outdir):
    """The dry run's CLI on the single mesh: the cells of ``DRYRUN_CELLS``
    ok, ``yi-34b`` x ``long_500k`` skipped, the SNN ok; no storage on the
    card.  Returns {(arch, shape): record}."""
    from repro_torch.launch import dryrun

    runs = [["--arch", a, "--shape", s] for a, s in DRYRUN_CELLS]
    runs += [["--arch", "yi-34b", "--shape", "long_500k"],
             ["--arch", "collision-snn"]]
    before = torch.cuda.memory_allocated()
    recs = {}
    for argv in runs:
        t0 = time.perf_counter()
        try:
            dryrun.main(argv + ["--mesh", "single", "--force", "--outdir",
                                str(outdir)])
        except SystemExit as e:
            fail(f"dryrun {' '.join(argv)}: exited {e.code}")
        secs = time.perf_counter() - t0
        arch = argv[1]
        shape = argv[3] if len(argv) > 2 else "train"
        with open(dryrun.cell_path(str(outdir), arch, shape, "single", None)) as f:
            recs[(arch, shape)] = rec = json.load(f)
        want = "skipped" if arch == "yi-34b" else "ok"
        if rec["status"] != want:
            fail(f"dryrun {arch} x {shape}: status {rec['status']}, want {want}"
                 f": {rec.get('error') or rec.get('reason')}")
        if want == "skipped":
            print(f"dryrun[{arch} x {shape}]: skipped ({rec['reason']}) in "
                  f"{secs:.2f} s")
            continue
        mem, cost, roof = rec["memory"], rec["cost"], rec["roofline"]
        colls = rec["collectives"]
        if cost["how"]["flops_per_device"] != "counted_partitioned":
            fail(f"dryrun {arch} x {shape}: not planned partitioned: "
                 f"{cost['how']}")
        print(f"dryrun[{arch} x {shape}]: {rec['chips']} devices "
              f"{rec['mesh_shape']}, planned partitioned in {rec['plan_s']} s "
              f"({secs:.2f} s with the JSON); per device: resident "
              f"{mem['resident_per_device']['total'] / 1e9:.3f} GB (exact), "
              f"peak {mem['peak_live_bytes'] / 1e9:.3f} GB, flops "
              f"{cost['flops_per_device']:.4g}, bytes "
              f"{cost['bytes_per_device']:.4g}, collective traffic "
              f"{colls['traffic_bytes']:.4g} B (all counted on one device of "
              f"the partitioned step); compute {roof['compute_s'] * 1e3:.3f} "
              f"ms, memory {roof['memory_s'] * 1e3:.3f} ms, collective "
              f"{roof['collective_s'] * 1e3:.3f} ms, {roof['dominant']} "
              f"dominant, useful flops {roof['useful_flops_ratio']:.3f}")
        if arch == "collision-snn":
            kinds = {k: (int(v["count"]), v["traffic_bytes"])
                     for k, v in colls["ops"].items()}
            axes = {a: sorted(k) for a, k in colls["by_axis"].items()}
            print(f"dryrun sharded[{arch} x single]: the step as DTensors over "
                  f"a fake group of {rec['chips']} ranks: collectives (count, "
                  f"traffic B a device) {kinds}, by mesh axis {axes}; "
                  f"{roof['dominant']} dominant (collective "
                  f"{roof['collective_s'] * 1e3:.4f} ms at "
                  f"{dryrun.LINK_BW:.4g} B/s)")
            if not colls["traffic_bytes"] > 0:
                fail(f"dryrun sharded {arch}: no collective counted")
    after = torch.cuda.memory_allocated()
    if after != before:
        fail(f"dryrun: the cells allocated {after - before} B on the card")
    return recs


def phase_dryrun(torch, dev, card, lm_train):
    """Phase 15: the dry run's cells on meta, each step partitioned as
    DTensors over a fake group of the mesh's size, then its plan of phase
    12's train step (unsharded, and partitioned on a (1, 1) mesh, which
    must agree) held against the same step on the card."""
    import shutil

    from repro_torch import configs
    from repro_torch.launch import dryrun, shapes
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.model import Model
    from repro_torch.optim import adam, chain_clip
    from repro_torch.train.loop import TrainState, make_step_parts

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    counted = lm_kernels()
    for fn in counted:
        fn.launches = 0
    outdir = ROOT / "build" / "dryrun_smoke"
    shutil.rmtree(outdir, ignore_errors=True)
    dryrun_cells(torch, outdir)
    shutil.rmtree(outdir, ignore_errors=True)

    # the plan of phase 12's step on one device: unsharded, and partitioned
    # on a mesh of one position, which must plan the same step
    sp = shapes.ShapeSpec(f"train_{LM_TRAIN_BATCH}x{LM_TRAIN_SEQ}",
                          LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train")
    rec = dryrun.run_cell(LM_ARCH, sp, "one", partitioned=False,
                          mesh_override=make_production_mesh(
                              shape=(1,), axes=("data",)))
    part = dryrun.run_cell(LM_ARCH, sp, "one",
                           mesh_override=make_production_mesh(
                               shape=(1, 1), axes=("data", "model")))
    same = {k: (part["cost"][k], rec["cost"][k]) for k in (
        "flops_per_device", "bytes_per_device")}
    same["peak_live_bytes"] = (part["memory"]["peak_live_bytes"],
                               rec["memory"]["peak_live_bytes"])
    print(f"dryrun plan[{LM_ARCH} x {sp.name}]: partitioned on a (1, 1) mesh "
          f"in {part['plan_s']} s against unsharded in {rec['plan_s']} s: "
          + ", ".join(f"{k} {a:.6g} vs {b:.6g}" for k, (a, b) in same.items())
          + f"; collective traffic {part['collectives']['traffic_bytes']} B")
    if any(a != b for a, b in same.values()) or \
            part["collectives"]["traffic_bytes"] != 0:
        fail(f"dryrun plan: the (1, 1) partitioned plan differs from the "
             f"unsharded one: {same}")
    planned = rec["memory"]["peak_live_bytes"]
    plan_start = rec["memory"]["step"]["start_bytes"]
    bound_ms = rec["roofline"]["bound_s"] * 1e3

    # the same step on the card: fresh state, fresh peak
    cfg = configs.get(LM_ARCH)
    floor = torch.cuda.memory_allocated()
    model = Model(cfg, dev)
    params = model.init(SEED)
    opt = chain_clip(adam(5e-4), 1.0)
    opt_state = opt.init(params)
    batches = lm_batches(cfg, dev)
    batch = next(batches)
    _, device = make_step_parts(model, opt)
    state = TrainState(params, opt_state, 0)
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated() - floor
    torch.cuda.reset_peak_memory_stats()
    m = device(state, batch, (params, opt_state))
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - floor
    loss = float(m["loss"])
    batch = next(batches)
    a, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    m = device(state, batch, (params, opt_state))
    e.record()
    torch.cuda.synchronize()
    step_ms = a.elapsed_time(e)
    loss2 = float(m["loss"])
    launched = {fn.__name__: fn.launches for fn in counted if fn.launches}
    if launched:
        fail(f"dryrun: the phase launched {launched}")
    if not (math.isfinite(loss) and math.isfinite(loss2)):
        fail(f"dryrun: the eager step's losses {loss}, {loss2}")
    off = planned / measured - 1.0
    print(f"dryrun plan[{LM_ARCH} x {sp.name}]: one device, planned on meta "
          f"in {rec['plan_s']} s: state and batch {plan_start / 1e9:.3f} GB, "
          f"peak {planned / 1e9:.3f} GB ({planned} B) | the same step eager "
          f"on the card: state and batch {start / 1e9:.3f} GB, peak "
          f"allocated {measured / 1e9:.3f} GB ({measured} B, less "
          f"{floor} B allocated before its objects) | plan {off:+.2%} of the "
          f"card (band {PLAN_BAND:.0%}) | phase 12's graphed step peaked at "
          f"{lm_train['peak'] / 1e9:.2f} GB | on {card}")
    if abs(off) > PLAN_BAND:
        fail(f"dryrun plan: planned peak {planned} B is {off:+.2%} of the "
             f"card's {measured} B (band {PLAN_BAND:.0%})")
    print(f"dryrun plan[{LM_ARCH} x {sp.name}]: a second eager step "
          f"{step_ms:.3f} ms (CUDA events; loss {loss:.4f} -> {loss2:.4f}) "
          f"against the cell's roofline bound {bound_ms:.3f} ms "
          f"({rec['roofline']['dominant']}: {rec['cost']['flops_global']:.4g} "
          f"counted flops at {dryrun.PEAK_FLOPS:.4g}/s, "
          f"{rec['cost']['bytes_global']:.4g} B of unfused op traffic at "
          f"{dryrun.HBM_BW:.4g} B/s); {step_ms / bound_ms:.2f}x the bound, "
          f"not gated | on {card}")
    del model, params, opt_state, state, batch, batches, m, device
    gc.collect()
    torch.cuda.empty_cache()
    print(f"dryrun: phase 15 took {time.perf_counter() - t_phase:.1f} s | on "
          f"{card}")


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the port's sources (src/repro_torch) are not "
              "beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the "
              "card and has no CPU fallback", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. environment
    card = card_line()
    print(card)
    from repro_torch.kernels import _build

    nvcc_v = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                            text=True, check=True, timeout=60).stdout
    print(f"torch {torch.__version__} | CUDA {torch.version.cuda} | "
          f"{nvcc_v.strip().splitlines()[-1]} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    report = _build.build_all()
    for name, rec in report.items():
        ptxas = [ln.strip() for ln in rec["log"].splitlines()
                 if "registers" in ln or "spill" in ln]
        print(f"build {name}: {rec['seconds']:.1f} s | " + " | ".join(ptxas))
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(report)} "
          f"kernel source(s)")
    budgets = phase_analysis(card)

    from repro_torch.configs.collision_snn import CONFIG

    params_np = weights_np(CONFIG.layer_sizes, SEED)
    dev = torch.device("cuda")
    # 3. kernel against plain version
    kern = phase_kernel(torch, dev, params_np, card)
    # 4. main path
    main_run = phase_main(torch, dev, params_np, card)
    # 5. aer kernel against plain version
    aer = phase_aer_kernel(torch, dev, params_np, card)
    # 6. training path
    train_run = phase_train(torch, dev, card)
    # 7. hardware path through the public kernel API
    hw = phase_hw_path(torch, dev, params_np, card)
    # 8. the API's kernels against their plain versions
    ops_k = phase_ops_kernels(torch, dev, hw, card)
    # 9. faults, admission, preemption and snapshots on the graph engine
    phase_faults(torch, dev, params_np, card)
    # 10. the event input path: DVS serving, capacity, AER-direct, BCNN
    events = phase_events(torch, dev, params_np, card, main_run)
    # 11. the LM zoo's serving path (decode attention and MLA decode its
    # kernels)
    da_row, mla_row = phase_lm(torch, dev, card)
    # 12. the LM zoo's training path (no kernel of the table on it either)
    lm_train = phase_lm_train(torch, dev, card)
    # 14. slot sharding over a mesh of the card; the GPipe pipeline
    sharded = phase_sharded(torch, dev, params_np, card, main_run)
    # 15. the dry run on meta, and its plan of phase 12's step on the card
    phase_dryrun(torch, dev, card, lm_train)

    odd = collections.Counter(x for x in RECORD_OFFSETS if x)
    print(f"profiler: {sum(odd.values())} of {len(RECORD_OFFSETS)} kernel "
          f"readings held records off a whole number a call (records less "
          f"reps x launches: {dict(odd)}); their times use each kernel's mean "
          f"duration")

    # 12. results
    dense = aer["layer0_dense_t0"]
    aer_cases = {name: {k: c[k] for k in ("variant", "ms", "alone_ms",
                                          "bound_ms", "library_ms")}
                 for name, c in aer.items()}
    rows = [{
        "name": "snn_chunk",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/snn_chunk.cu",
        "replaces": "src/repro/kernels/snn_chunk.py:221",
        "launches": main_run["launches"],
        "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"],
        "plain_ms": kern["plain_ms"],
        "bound_ms": kern["bound_ms"],
        "bound_by": kern["bound_by"],
        "library_ms": None,
        "cases": events["cases"],
        "launches_sharded": sharded["launches"],
    }, {
        "name": "aer_spike_matmul_batched",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/aer_matmul.cu",
        "replaces": "src/repro/kernels/aer_matmul.py:126",
        "launches": train_run["launches"],
        "launches_graph": {k: train_run[k] for k in (
            "captured", "replays", "warmup_launches")},
        "max_abs_err": max(c["max_abs_err"] for c in aer.values()),
        "ms": dense["ms"],
        "plain_ms": dense["plain_ms"],
        "bound_ms": dense["bound_ms"],
        "bound_by": dense["bound_by"],
        "library_ms": dense["library_ms"],
        "ms_sparse": aer["layer0_sparse_t24"]["ms"],
        "ms_layer1": aer["layer1"]["ms"],
        "cases": aer_cases,
        "launches_inference": events["aer_launches"],
    }] + ops_rows(hw, ops_k) + [dict(
        name="decode_attention", route="cuda",
        source="src/repro_torch/kernels/csrc/decode_attention.cu",
        replaces=None, **da_row), dict(
        name="mla_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/mla_decode.cu",
        replaces=None, **mla_row)]
    for row in rows:
        p = budgets[row["name"]]
        row["budget"] = {k: p[k] for k in (
            "registers", "spill_bytes", "smem_bytes", "static_smem_bytes",
            "threads", "cluster", "ctas")}
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
