"""Event-driven training of the SNN through ``EventTrainer``'s graphed step.

Traffic keys: ``batch`` signed DVS recordings of ``num_steps`` steps a
step (``image_hw``, ``polarity``, ``delta_threshold``, AER ``capacity``
per recording), rendered on the card by the frozen camera inside the
window as a data loader would, the batch of step ``s`` drawn from
``(seed, s)``; the paper's Adam (``lr``) with global-norm clipping
(``clip``); ``judged_steps`` first steps the reference follows;
``checks`` each compared number's limit.  Dropout follows the
configuration; its uniforms are drawn, as the trainer draws them, from
``(seed, step)``.
"""

from __future__ import annotations

from portbench import trainjudge
from portbench.cellbase import CellBase, generator_seed
from portbench.frozen import bounds, dvs
from portbench.refs import snn_ref
from portbench.refs.precision import matmul_precision


def batch_at(mix, seed: int, step: int, device) -> dict:
    """Step ``step``'s batch: ``batch`` recordings drawn from
    ``(seed, step)`` as signed planes (B, T, K) on ``device``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(dvs.mix_seed(seed, step))
    T, hw = mix["num_steps"], mix["image_hw"]
    stream, labels = dvs.dvs_collision_batch(
        gen, mix["batch"], image_hw=hw, num_steps=T, capacity=mix["capacity"],
        delta_threshold=mix["delta_threshold"])
    planes = dvs.input_planes(stream, T, hw * hw,
                              polarity_mode=mix["polarity"])
    return {"spikes": planes.transpose(0, 1), "labels": labels,
            "step_seed": torch.full((mix["batch"],), step, dtype=torch.int64)}


def dropout_u(cfg, mix, seed: int, step: int, device):
    """The trainer's dropout uniforms of step ``step`` (T, B, hidden): one
    (B, hidden) draw a time step from a generator seeded by
    ``(seed, step)``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(dvs.mix_seed(seed, step))
    B, H = mix["batch"], cfg["layer_sizes"][1]
    return torch.stack([torch.rand((B, H), generator=gen, device=device)
                        for _ in range(mix["num_steps"])])


def weights(cfg, seed, device):
    import torch

    gen = torch.Generator(device=device).manual_seed(generator_seed(seed))
    return snn_ref.init_params(gen, cfg["layer_sizes"], cfg["beta_init"],
                               cfg["threshold_init"], device)


def flat(tree) -> dict:
    return {f"{ln}/{k}": v for ln, lp in tree.items() for k, v in lp.items()}


def reference(cfg, mix, seed, device, tf32=False, rows=None) -> dict:
    """The reference's first ``judged_steps`` steps from the seed's
    weights on the seed's batches and dropout draws (``rows``: only those
    rows of each batch, the planted half-batch fault)."""
    import torch

    params = weights(cfg, seed, device)
    start = {n: v.clone() for n, v in flat(params).items()}
    opt = snn_ref.adam_init(params)
    out = {"loss": []}
    rate = cfg["dropout_rate"]
    with matmul_precision(tf32=tf32):
        for step in range(mix["judged_steps"]):
            b = batch_at(mix, seed, step, device)
            x, y = b["spikes"].transpose(0, 1), b["labels"]
            u = dropout_u(cfg, mix, seed, step, device) if rate > 0 else None
            if rows is not None:
                x, y = x[:, rows], y[rows]
                u = None if u is None else u[:, rows]
            margins = [] if step == 0 else None
            loss, grads, events = snn_ref.train_step(
                params, opt, x, y, lr=mix["lr"], clip=mix["clip"],
                dropout_u=u, rate=rate, margins=margins)
            out["loss"].append(float(loss))
            if step == 0:
                out["crossings"] = near_threshold(margins)
                out["variant"] = _variant(start, x, y, u, mix["clip"], rate,
                                          tf32)
                out["first_spikes"] = events[1]
                out["grads"] = {f"{ln}/{k}": g for (ln, k), g in grads.items()}
                out["grad"] = {f"{ln}/{k}": float(torch.linalg.vector_norm(g))
                               for (ln, k), g in grads.items()}
                # one clip scale for every leaf: the tiny-gradient rule
                # reads the same on the clipped norms
                out["grad_raw"] = dict(out["grad"])
    out["change"] = {n: float(torch.linalg.vector_norm(v - start[n]))
                     for n, v in flat(params).items()}
    return out


# a crossing within KAPPA float32 roundings of its threshold may fall on
# either side in a float32 sum of another order; the judge follows the
# program's side at up to FOLLOW of the MAX_CROSSINGS nearest
KAPPA = 16.0
MAX_CROSSINGS = 48
FOLLOW = 4
FOLLOW_FROM = 1e-5  # a first_grad_diff at or under this needs no search


def near_threshold(margins) -> list:
    """(t, layer, row, neuron) of the step's crossings whose
    pre-activation lies within ``KAPPA`` float32 roundings of its
    threshold, nearest first, at most ``MAX_CROSSINGS``."""
    import torch

    near = []
    for t, i, m, r in margins:
        ratio = m.abs() / torch.clamp(KAPPA * r, min=1e-30)
        for b, j in (ratio <= 1.0).nonzero().tolist():
            near.append((float(ratio[b, j]), (t, i, b, j)))
    near.sort()
    return [k for _, k in near[:MAX_CROSSINGS]]


def _variant(start, x, y, u, clip, rate, tf32):
    """The reference's first gradient, as the optimizer gets it, with the
    given crossings put on their threshold's other side."""
    import torch

    params = {}
    for n, v in start.items():
        ln, k = n.split("/")
        params.setdefault(ln, {})[k] = v

    def grads(keys) -> dict:
        flips = {}
        for t, i, b, j in keys:
            if (t, i) not in flips:
                N = params[f"layer{i}"]["w"].shape[1]
                flips[(t, i)] = torch.zeros((x.shape[1], N), device=x.device)
            flips[(t, i)][b, j] = 1.0
        with matmul_precision(tf32=tf32):
            _, g, _ = snn_ref.clipped_grads(params, x, y, clip=clip,
                                            dropout_u=u, rate=rate,
                                            flips=flips)
        return {f"{ln}/{k}": v for (ln, k), v in g.items()}

    return grads


def _follow(worst, ref: dict, raw: float):
    """The reference's first gradient once it takes the program's side at
    up to ``FOLLOW`` crossings near their threshold, picked greedily (each
    crossing's change to the gradient added alone, the pick then run
    whole), and ``worst`` of it: float32 decides those crossings by its
    sum's order, so either side is the reference's.  Returns (``worst``,
    the gradient); the reference's own where nothing comes nearer."""
    base, variant = ref["grads"], ref["variant"]
    if raw <= FOLLOW_FROM or not ref["crossings"]:
        return raw, base
    deltas = {}
    for a in ref["crossings"]:
        g = variant([a])
        deltas[a] = {n: g[n] - base[n] for n in base}
    chosen, current, best = [], dict(base), raw
    for _ in range(FOLLOW):
        trials = {a: worst({n: current[n] + d[n] for n in current})
                  for a, d in deltas.items() if a not in chosen}
        if not trials:
            break
        a = min(trials, key=trials.get)
        if trials[a] >= best:
            break
        chosen.append(a)
        current = {n: current[n] + deltas[a][n] for n in current}
        best = trials[a]
    if not chosen:
        return raw, base
    followed = variant(chosen)
    got = worst(followed)
    return (got, followed) if got < raw else (raw, base)


def readings(prog: dict, ref: dict) -> dict:
    """``trainjudge.readings`` and two numbers of the first step alone,
    before any update: ``first_spike_gap``, the gap in the hidden spikes
    a recording over the reference's; ``first_grad_diff``, by the worst
    leaf, the norm of the difference between the program's gradient as
    the optimizer got it and the reference's, over the reference's norm
    of that leaf or of the median leaf, whichever is larger, once the
    reference takes the program's side of the crossings that float32's
    sum order can decide either way (``_follow``).  A flipped hidden spike
    moves every leaf's gradient as far as TF32 does; TF32 also rounds
    every product and flips spikes far from any threshold.
    ``grad_norm_gap`` is read against the same followed gradient;
    ``first_grad_diff_raw`` and ``grad_norm_gap_raw`` are both before
    that."""
    import torch

    got = trainjudge.readings(prog, ref)
    got["first_spike_gap"] = (abs(prog["first_spikes"] - ref["first_spikes"])
                              / max(ref["first_spikes"], 1.0))
    norms = {n: float(torch.linalg.vector_norm(g))
             for n, g in ref["grads"].items()}
    med = sorted(norms.values())[len(norms) // 2]

    def worst(grads) -> float:
        return max(float(torch.linalg.vector_norm(prog["grads"][n] - g))
                   / max(norms[n], med, 1e-30) for n, g in grads.items())

    raw = worst(ref["grads"])
    got["first_grad_diff_raw"] = raw
    got["crossings_near_threshold"] = float(len(ref["crossings"]))
    got["first_grad_diff"], grads = _follow(worst, ref, raw)
    followed = {n: float(torch.linalg.vector_norm(g))
                for n, g in grads.items()}
    got["grad_norm_gap_raw"] = got["grad_norm_gap"]
    got["grad_norm_gap"] = max(trainjudge.leaf_gaps(
        prog["grad"], followed, sorted(followed)).values())
    return got


def events_and_rows(batch) -> dict:
    """What layer 0's AER products of one step must move (the bytes bound
    of ``aer_matmul``): its events and the distinct W0 rows they touch,
    each once a step.  Layer 0's inputs are the camera's planes, which
    need no state of an earlier time step, so one pass over the step's
    rows serves all ``T`` of them, however the program launches them."""
    hit = batch["spikes"] != 0  # (B, T, K)
    return {"events0": float(hit.sum()),
            "rows0": float(hit.any(0).any(0).sum())}  # (K,) rows, each once


class Cell(CellBase):
    def setup(self) -> None:
        import torch
        from repro_torch.sparse_train.trainer import (EventTrainConfig,
                                                       EventTrainer)
        from repro_torch.train.loop import TrainState

        cfg, mix = self.cfg, self.mix
        tcfg = EventTrainConfig(
            image_hw=mix["image_hw"], num_steps=mix["num_steps"],
            hidden=cfg["layer_sizes"][1], polarity_mode=mix["polarity"],
            dvs_capacity=mix["capacity"],
            delta_threshold=mix["delta_threshold"],
            dropout_rate=cfg["dropout_rate"])
        if tcfg.snn_config().layer_sizes != tuple(cfg["layer_sizes"]):
            raise ValueError(f"the trainer's layers {tcfg.snn_config()} "
                             f"are not {cfg['layer_sizes']}")
        self.trainer = EventTrainer(tcfg, use_kernel=True, lr=mix["lr"],
                                    seed=self.seed, device=self.device)
        params = weights(cfg, self.seed, self.device)
        self.state = TrainState(params, self.trainer.optimizer.init(params), 0)
        self.step_index = 0

        def read_first():
            mu = flat(self.state.opt_state.mu)
            self.first["grads"] = {n: v / (1 - 0.9) for n, v in mu.items()}
            self.first["grad"] = {
                n: float(torch.linalg.vector_norm(g))
                for n, g in self.first["grads"].items()}
            self.bytes_in = events_and_rows(self._last)

        hidden = [m["events_l1"] for m in self.judged_steps(
            read_first, keys=("loss", "events_l1"))]
        self.first["first_spikes"] = hidden[0]
        self.record_change(lambda: flat(weights(cfg, self.seed, self.device)),
                           flat(self.state.params))
        self.hidden_events = sum(hidden) / len(hidden)
        step = self.trainer.step_fn
        self.log(f"set-up steps: {mix['judged_steps']} (captures "
                 f"{step.captures}, replays {step.replays}) | losses "
                 f"{self.first['loss']} | layer-0 events a step "
                 f"{self.bytes_in['events0']:.0f}, hidden events a "
                 f"recording {self.hidden_events:.1f}")

    def _step(self):
        """The window's call and feed: the frozen camera renders the next
        batch on the card, then one step of the trainer."""
        with self.spans.span("render"):
            batch = batch_at(self.mix, self.seed, self.step_index,
                             self.device)
            self._last = batch
        with self.spans.span("step"):
            self.state, m = self.trainer.step_fn(self.state, batch)
        self.step_index += 1
        return m

    def captures(self) -> int:
        return self.trainer.step_fn.captures

    def window(self, seconds: float) -> dict:
        return self.train_window(seconds, "snn_train_step_ms")

    def layer_ctx(self) -> dict:
        widths = list(self.cfg["layer_sizes"])
        B, T = self.mix["batch"], self.mix["num_steps"]
        ev1 = self.hidden_events * B
        b = self.bytes_in
        aer_bytes = (bounds.aer_gather_bytes(b["rows0"], widths[1],
                                             b["events0"], B * T)
                     + bounds.aer_gather_bytes(min(widths[1], ev1),
                                               widths[2], ev1, B * T))
        return {"train": {
            "steps": self.steps,
            "flops_per_step": bounds.snn_train_flops(
                widths, T, B, [b["events0"], ev1]),
            "peak_flops": bounds.F32_FLOPS,
            "aer_bytes_per_step": aer_bytes}}

    def release(self) -> None:
        del self.trainer, self.state, self._last
        self.free_card()

    def judge(self) -> dict:
        ref = reference(self.cfg, self.mix, self.seed, self.device)
        got = readings(self.first, ref)
        told = {k: v for k, v in got.items() if k not in self.mix["checks"]}
        self.log(f"judged: not compared {told} | losses {self.first['loss']}"
                 f" | reference losses {ref['loss']}")
        return self.checks(got)


def control(cfg, mix, seed, device) -> dict:
    """The control (the reference with its products in TF32, the
    precision below float32 with TF32 off) and the planted faults, each
    read against the float32 reference."""
    ref = reference(cfg, mix, seed, device)
    half = list(range(mix["batch"] // 2))
    still = dict(ref, change={n: 0.0 for n in ref["change"]})
    return {"excluded": trainjudge.excluded(ref),
            "control_tf32": readings(
                reference(cfg, mix, seed, device, tf32=True), ref),
            "half_batch": readings(
                reference(cfg, mix, seed, device, rows=half), ref),
            "state_unchanged": readings(still, ref)}

