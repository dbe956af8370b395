"""Closed-loop serving of DVS windows through ``SNNStreamEngine``.

Traffic keys: ``clients`` cameras, each sending its next window when the
answer to its last returns; ``slots``, ``chunk_steps``, ``backend``,
``cuda_graph``, ``pipeline_depth`` of the engine; windows of
``window_steps`` steps from a pool of ``pool`` recordings of the frozen
camera (``image_hw``, ``polarity``, ``delta_threshold``, AER
``capacity``), rendered in set-up from the seed; ``host_threads`` of the
process (the harness sets them); each client draws its
next recording from its own seeded stream.  The clients join in set-up,
``stagger`` groups one poll apart, and the loop runs ``ramp_polls``
polls before the window opens on it.  ``checks`` gives each compared
number's limit.
"""

from __future__ import annotations

import numpy as np

from portbench import harness
from portbench.cellbase import CellBase, generator_seed, now
from portbench.frozen import bounds, dvs
from portbench.refs import snn_ref
from portbench.refs.precision import matmul_precision

HIST = ("engine.tick.host_prep_s", "engine.tick.dispatch_s",
        "engine.tick.stats_fetch_s", "engine.request.queue_wait_s")


def make_inputs(cfg, mix, seed, device):
    """The benchmark's weights and recordings, both from ``seed`` on
    ``device``: (params, planes (R, T, K))."""
    import torch

    gen = torch.Generator(device=device).manual_seed(generator_seed(seed))
    params = snn_ref.init_params(gen, cfg["layer_sizes"], cfg["beta_init"],
                                 cfg["threshold_init"], device)
    T, hw = mix["window_steps"], mix["image_hw"]
    stream, _ = dvs.dvs_collision_batch(
        gen, mix["pool"], image_hw=hw, num_steps=T, capacity=mix["capacity"],
        delta_threshold=mix["delta_threshold"])
    planes = dvs.input_planes(stream, T, hw * hw,
                              polarity_mode=mix["polarity"])
    return params, planes.transpose(0, 1).contiguous()


def snn_config(cfg):
    from repro_torch.core import snn

    return snn.SNNConfig(
        layer_sizes=tuple(cfg["layer_sizes"]), num_steps=cfg["num_steps"],
        neuron_kind=cfg["neuron_kind"], reset=cfg["reset"],
        surrogate=cfg["surrogate"], refractory_steps=cfg["refractory_steps"],
        dropout_rate=cfg["dropout_rate"], beta_init=cfg["beta_init"],
        threshold_init=cfg["threshold_init"])


def compare(results, ref) -> dict:
    """The numbers a served window is judged by, over every judged answer
    (recording index, ``StreamResult``): answers that are not ``ok``;
    the largest gap in layer-0 input events (exact: they are the input,
    counted, not computed); ``spike_gap``, the summed absolute gap in the
    spikes of every later layer (the hidden layer's and the output
    counts) over the reference's sum; ``output_spike_gap``, the output
    counts' summed gap over the reference's output spikes or the answers,
    whichever is more (the random network's outputs seldom spike, so a
    flipped spike reads at most one over the answers); and
    ``prediction_gap``, the share of answers whose prediction (the count
    argmax, ties broken by the summed output membranes: the membrane
    readout) differs.  Told beside them: the hidden gap apart and the
    reference's sums."""
    counts = ref["counts"].cpu().numpy()
    hidden = ref["hidden"].cpu().numpy()
    inputs = ref["inputs"].cpu().numpy()
    pred = ref["prediction"].cpu().numpy()
    bad, in_gap, h_gap, h_sum, o_gap, o_sum, p_bad = 0, 0.0, 0.0, 0.0, 0.0, 0.0, 0
    for rec, r in results:
        if r.disposition != "ok":
            bad += 1
            continue
        ev = np.asarray(r.events_per_layer, np.float64)
        in_gap = max(in_gap, abs(ev[0] - inputs[rec]))
        h_gap += abs(ev[1] - hidden[rec])
        h_sum += hidden[rec]
        o_gap += float(np.abs(np.asarray(r.spike_counts) - counts[rec]).sum())
        o_sum += float(counts[rec].sum())
        p_bad += int(r.prediction != pred[rec])
    ok = max(len(results) - bad, 1)
    return {"answers_not_ok": float(bad), "input_events_gap": float(in_gap),
            "spike_gap": float((h_gap + o_gap) / max(h_sum + o_sum, 1.0)),
            "hidden_spike_gap": float(h_gap / max(h_sum, 1.0)),
            "output_spike_gap": float(o_gap / max(o_sum, ok)),
            "prediction_gap": p_bad / ok,
            "hidden_spikes": float(h_sum), "output_spikes": float(o_sum)}


class Cell(CellBase):
    def setup(self) -> None:
        from repro_torch.serving.snn_engine import (SNNStreamEngine,
                                                    StreamRequest)

        mix = self.mix
        params, planes = make_inputs(self.cfg, mix, self.seed, self.device)
        self.pool = planes.cpu().numpy()
        self.w0_rows = self._rows_per_launch(planes)
        events = float((planes != 0).sum()) / planes.shape[0]
        del planes
        self.T = int(mix["window_steps"])
        self.engine = SNNStreamEngine(
            params, snn_config(self.cfg), num_slots=mix["slots"],
            chunk_steps=mix["chunk_steps"], seed=generator_seed(self.seed, 1),
            backend=mix["backend"] if self.on_card else "torch",
            pipeline_depth=mix["pipeline_depth"],
            cuda_graph=mix["cuda_graph"],
            # a traced run keeps every span of its window for snn.admit_ms
            trace_capacity=mix["trace_capacity"] if self.spans.traced
            else 8192,
            device=self.device)
        # warm-up: one window on every slot grows the ring to T and
        # captures the (spikes, T) admission graph and the tick graph
        for i in range(mix["slots"]):
            self.engine.submit(StreamRequest(
                spikes=self.pool[i % len(self.pool)], num_steps=self.T))
        self.engine.drain(timeout_s=300)
        self.sync()
        self._start_loop()
        e = self.engine
        self.log(f"warm-up: captures {self.captures()} (tick "
                 f"{e.graph_captures}, admission {e.admit_captures}) | ring "
                 f"{e._ring_steps} steps | {mix['slots']} slots | pool "
                 f"{len(self.pool)} x {self.T} steps | W0 rows a launch "
                 f"{self.w0_rows:.1f} | input events a window {events:.1f}")

    def _rows_per_launch(self, planes) -> float:
        """W0 rows a launch's events touch, each once: the mean union of
        addresses over ``slots`` windows at random chunk offsets, from
        the pool (the bytes bound of ``snn_chunk``)."""
        import torch

        R, T, _ = planes.shape
        S, Tc = self.mix["slots"], self.mix["chunk_steps"]
        g = torch.Generator(device=planes.device).manual_seed(
            generator_seed(self.seed, 2))
        rows = []
        for _ in range(8):
            rec = torch.randint(R, (S,), generator=g, device=planes.device)
            k = torch.randint(T // Tc, (S,), generator=g, device=planes.device)
            steps = k[:, None] * Tc + torch.arange(Tc, device=planes.device)
            hit = planes[rec[:, None], steps] != 0  # (S, Tc, K)
            rows.append(float(hit.any(0).any(0).sum()))
        return sum(rows) / len(rows)

    def captures(self) -> int:
        return self.engine.graph_captures + self.engine.admit_captures

    def _start_loop(self) -> None:
        """The closed loop, started in set-up: the clients join in
        ``stagger`` groups, one group a poll, so their windows are spread
        over the ticks as independent cameras' are (all joining at once
        would keep them in one convoy that finishes and re-admits
        together); then ``ramp_polls`` polls reach the steady loop."""
        mix = self.mix
        n = mix["clients"]
        self.rngs = [np.random.default_rng([self.seed & 0xFFFFFFFF,
                                            self.seed >> 32, c])
                     for c in range(n)]
        self.owner, self.results, self.lat = {}, [], []
        self.open, self.counting = True, False
        groups = mix["stagger"]
        for g in range(groups):
            for c in range(g, n, groups):
                self._send(c)
            self._poll()
        for _ in range(mix["ramp_polls"]):
            self._poll()

    def _send(self, c: int) -> None:
        from repro_torch.serving.snn_engine import StreamRequest

        rec = int(self.rngs[c].integers(len(self.pool)))
        t = now()
        with self.spans.span("submit"):
            rid = self.engine.submit(StreamRequest(spikes=self.pool[rec],
                                                   num_steps=self.T))
        self.owner[rid] = (c, rec, t)
        self.attempted += 1

    def _poll(self) -> float:
        """One poll; each answer's client sends its next window at once."""
        with self.spans.span("poll"):
            out = self.engine.poll()
        t = now()
        for r in out:
            c, rec, ts = self.owner.pop(r.request_id)
            self.results.append((rec, r))
            if self.counting:
                self.lat.append(t - ts)
                self.done_in.append(r)
            if self.open:
                self._send(c)
        return t

    def window(self, seconds: float) -> dict:
        e, mix = self.engine, self.mix
        snap0 = e.metrics_snapshot()
        replays0 = e.graph_replays
        sent0 = self.attempted
        self.done_in = []
        with self.spans.span("measured"):
            t0 = now()
            self.counting = True
            while True:
                t = self._poll()
                if t - t0 >= seconds:
                    break
            self.counting = self.open = False
        self.window_s = t - t0
        lat, done = self.lat, self.done_in
        n_in = len(done)
        snap1 = e.metrics_snapshot()
        launches = e.graph_replays - replays0
        spans = [s for s in e.trace.spans() if s.name == "stage"
                 and t0 <= s.t0 <= t]
        ev0 = sum(float(r.events_per_layer[0]) for r in done)
        ev1 = sum(float(r.events_per_layer[1]) for r in done)
        widths = list(self.cfg["layer_sizes"])
        steps_done = sum(int(r.steps) for r in done)
        self._ctx = {"snn_serve": {
            "hist": {h: harness.histogram_delta(snap0[h], snap1[h])
                     for h in HIST},
            "stage_s": [s.t1 - s.t0 for s in spans],
            "launches": launches,
            "bytes_per_launch": bounds.snn_chunk_bytes(
                mix["slots"], mix["chunk_steps"], widths,
                # the work of answers in flight at the window's two ends
                # about cancels in a steady loop
                ev0 / max(launches, 1), self.w0_rows),
            "flops": bounds.snn_forward_flops(widths, steps_done,
                                              [ev0, ev1]),
        }}
        host = {k: round(self.spans.sums.get(k, 0.0), 6)
                for k in ("submit", "poll")}
        self.log(f"served: {n_in} answers in {self.window_s:.3f} s "
                 f"({self.attempted - sent0} sent), {launches} tick "
                 f"launches, {steps_done} slot-steps answered | host "
                 f"seconds since the loop began: {host}")
        owner = self.owner
        # answers still in flight are not the window's; they are judged
        with self.spans.span("drain"):
            for r in e.drain(timeout_s=120):
                c, rec, ts = owner.pop(r.request_id)
                self.results.append((rec, r))
        self.failed = sum(r.disposition != "ok" for _, r in self.results)
        self.failed += len(owner)  # never answered
        self.missing = len(owner)
        return {"snn_req_per_s": n_in / self.window_s,
                "snn_latency_p95_ms": harness.nearest_rank(lat, 95) * 1e3}

    def layer_ctx(self) -> dict:
        return self._ctx

    def release(self) -> None:
        del self.engine
        self.free_card()

    def judge(self) -> dict:
        params, planes = make_inputs(self.cfg, self.mix, self.seed,
                                     self.device)
        with matmul_precision(tf32=False):
            ref = snn_ref.serve_readout(params, planes)
        values = compare(self.results, ref)
        values["answers_not_ok"] += self.missing
        told = {k: v for k, v in values.items() if k not in self.mix["checks"]}
        self.log(f"judged: {len(self.results)} answers | not compared: "
                 f"{told}")
        return self.checks(values)


class _Answer:
    """A reference readout in the shape of a served answer."""

    disposition = "ok"

    def __init__(self, ref, r: int):
        self.prediction = int(ref["prediction"][r])
        self.spike_counts = ref["counts"][r].cpu().numpy()
        self.events_per_layer = [float(ref["inputs"][r]),
                                 float(ref["hidden"][r])]


def control(cfg, mix, seed, device) -> dict:
    """The control's readings: the reference in the program's place with
    its products in TF32 (the precision below float32 with TF32 off),
    judged against the float32 reference, every recording of the pool
    once."""
    params, planes = make_inputs(cfg, mix, seed, device)
    with matmul_precision(tf32=False):
        ref = snn_ref.serve_readout(params, planes)
    with matmul_precision(tf32=True):
        low = snn_ref.serve_readout(params, planes)
    return compare([(r, _Answer(low, r)) for r in range(planes.shape[0])],
                   ref)


def _readout_no_leak():
    """Every engine built with its readout layer's (the last) leak dropped,
    beta 1, in a copy of the weights; the reference keeps the seed's.
    Returns the undo."""
    import torch
    from repro_torch.serving import snn_engine

    real = snn_engine.SNNStreamEngine.__init__

    def init(self, params, *a, **k):
        params = {n: dict(lp) for n, lp in params.items()}
        last = params[f"layer{len(params) - 1}"]
        last["beta_raw"] = torch.full_like(last["beta_raw"], 40.0)
        real(self, params, *a, **k)

    snn_engine.SNNStreamEngine.__init__ = init
    return lambda: setattr(snn_engine.SNNStreamEngine, "__init__", real)


def _counts_off_by_one():
    """Each answer's last output count one high where ``_finalize``
    produces it.  Returns the undo."""
    from repro_torch.serving import snn_engine

    real = snn_engine.SNNStreamEngine._finalize

    def finalize(self, s):
        r = real(self, s)
        r.spike_counts = np.asarray(r.spike_counts, np.float64).copy()
        r.spike_counts[-1] += 1.0
        return r

    snn_engine.SNNStreamEngine._finalize = finalize
    return lambda: setattr(snn_engine.SNNStreamEngine, "_finalize", real)


# faults of the readout planted under the timed path, each read on the
# card by ``control.py --fault``: the upper readings of
# ``output_spike_gap`` and ``prediction_gap``
FAULTS = {
    "readout_no_leak": _readout_no_leak,
    "counts_off_by_one": _counts_off_by_one,
}
