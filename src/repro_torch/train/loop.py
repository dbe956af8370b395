"""Training loop substrate: step builder, grad accumulation, metrics,
checkpoint/restart, straggler watchdog and ``repro_torch.obs`` wiring.

A model is any object with ``init(seed) -> params`` and
``loss(params, batch) -> (loss, metrics)``; params are a tree
(``repro_torch.tree``) of float tensors: the event SNN
(``sparse_train.trainer.EventSNNModel``) and the LM zoo's
``models.model.Model``.  A model may also have
``prepare(batch) -> batch``, the host part of its loss (the event SNN
seeds its dropout generator there and draws the masks' uniforms); its
loss then takes a prepared batch and reads the host nowhere.
``make_train_step`` builds the eager step: autograd over the loss, the
optimizer update, a new state.  ``make_step_parts`` builds the static
one, which writes the new state leaf by leaf into buffers
(``optim.adam.update_into``): the same values, with one leaf's
temporaries live at a time in place of a tree of each, so that a
full-width LM's step fits beside its params and Adam state.

``Trainer(jit=True, donate=True)``, the counterpart of the reference's
``jax.jit(step, donate_argnums=(0,))``, runs the step as a
``StaticStep``: over static state and batch buffers, captured once per
batch signature into a ``torch.cuda.CUDAGraph`` on the card and replayed
every step (uncaptured on the CPU, which has no graphs), the state
updated in place.  ``jit=False`` is the eager step.  On the card the
static step's update phase (the norms, the clip and the leaf-by-leaf
optimizer and apply) is bracketed by phase markers (``kernels.markers``:
``update_begin`` once the gradients are computed, ``update_end`` after
the last leaf), which the graph records, so the profiler's trace shows
the optimizer's share of a replay.

Every ``Trainer`` carries a ``MetricsRegistry`` (``trainer.metrics``:
step-time / loss / grad-norm histograms, step counters, latest-metrics
gauges under ``train.metrics.*``), a ``TraceRecorder`` (``trainer.trace``:
one span per sync window on the ``train`` track, straggler warnings as
instants) and a ``TimeSeriesSampler`` (``trainer.timeseries``: one point
per log window).  The host reads device values only at ``log_every``
sync windows, in one transfer, so a step never waits on the device and
the instruments add no sync of their own.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch.analysis import contracts
from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed import partitioning
from repro_torch.kernels import markers
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.timeseries import TimeSeriesSampler
from repro_torch.obs.trace import TraceRecorder
from repro_torch.optim.adam import (
    Optimizer,
    apply_updates,
    global_norm,
    update_into,
)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten

Tree = Any


class TrainState(NamedTuple):
    params: Tree
    opt_state: Tree
    step: int  # host-side counter: reading it never waits on the device


def _step_fns(model, accum_steps: int) -> Tuple[Callable, Callable]:
    """``host(batch) -> batch`` runs the model's ``prepare`` on each
    microbatch (nothing without one); ``grads(params, batch) -> (metrics,
    gradient leaves in walk order)``, which reads the host nowhere.  With
    accum_steps > 1 the batch's leading dim must be (accum_steps *
    microbatch); gradients are summed over the microbatches in order and
    averaged."""
    prepare = getattr(model, "prepare", None)

    def micro(batch, j):
        return {k: v.reshape(accum_steps, -1, *v.shape[1:])[j]
                for k, v in batch.items()}

    def host(batch):
        if prepare is None:
            return batch
        if accum_steps == 1:
            return prepare(batch)
        mbs = [prepare(micro(batch, j)) for j in range(accum_steps)]
        added = [k for k in mbs[0] if k not in batch]
        return {**batch, **{k: torch.cat([mb[k] for mb in mbs]) for k in added}}

    def grads_of(params, batch):
        live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        with torch.enable_grad():
            loss, metrics = model.loss(tree_unflatten(params, live), batch)
            grads = torch.autograd.grad(loss, live)
        return loss.detach(), metrics, [partitioning.constrain_like(g, p)
                                        for g, p in zip(grads, live)]

    def grads(params, batch):
        if accum_steps == 1:
            _, metrics, g = grads_of(params, batch)
            return dict(metrics), g
        gsum, lsum = None, 0.0
        for j in range(accum_steps):
            l, _, g = grads_of(params, micro(batch, j))
            gsum = g if gsum is None else [a + b for a, b in zip(gsum, g)]
            lsum = lsum + l
        return {"loss": lsum / accum_steps}, [g / accum_steps for g in gsum]

    return host, grads


def make_step_parts(
    model, optimizer: Optimizer, accum_steps: int = 1
) -> Tuple[Callable, Callable]:
    """The static step in two parts: ``host(batch) -> batch`` (the model's
    ``prepare``, ``_step_fns``), and ``device(state, batch, out) ->
    metrics``, which reads the host nowhere, so a CUDA graph can capture
    it: autograd over the loss, then the optimizer's step written leaf by
    leaf into ``out``, a ``(params, opt_state)`` pair of buffers that may
    be the state's own (``optim.adam.update_into``); ``out=None`` computes
    it and changes nothing (a warm-up).  The update phase lies between the
    ``update_begin`` and ``update_end`` markers."""
    host, grads_fn = _step_fns(model, accum_steps)

    def device(state: TrainState, batch: Dict[str, torch.Tensor], out):
        metrics, grads = grads_fn(state.params, batch)
        where = grads[0].device
        markers.mark("update_begin", where)
        with torch.no_grad():
            metrics["grad_norm"] = global_norm(grads)
            update_into(optimizer, grads, state.opt_state, state.params, out)
        markers.mark("update_end", where)
        return metrics

    return host, device


def make_train_step(
    model, optimizer: Optimizer, accum_steps: int = 1
) -> Callable:
    """The eager step, (state, batch) -> (state, metrics): the host part,
    autograd, then the optimizer's update over whole trees, a new state
    each call (the same values as ``make_step_parts``'s step)."""
    host, grads_fn = _step_fns(model, accum_steps)

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        metrics, grads = grads_fn(state.params, host(batch))
        with torch.no_grad():
            grads = tree_unflatten(state.params, grads)
            updates, opt_state = optimizer.update(grads, state.opt_state,
                                                  state.params)
            params = apply_updates(state.params, updates)
            metrics["grad_norm"] = global_norm(grads)
        return TrainState(params, opt_state, state.step + 1), metrics

    return train_step


def same_storages(a: Tree, b: Tree) -> bool:
    """Whether trees ``a`` and ``b`` hold the same storages, leaf by leaf."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.data_ptr() == y.data_ptr() and x.shape == y.shape
        and x.stride() == y.stride() and x.dtype == y.dtype
        and x.device == y.device
        for x, y in zip(la, lb)
    )


def _copy_into(buffers: Tree, tree: Tree) -> None:
    with torch.no_grad():
        for buf, x in zip(tree_leaves(buffers), tree_leaves(tree)):
            buf.copy_(x)


class StaticStep:
    """The step over static buffers: the counterpart of the reference's
    ``jax.jit(step, donate_argnums=(0,) if donate else ())``.

    The params and optimizer state live in one set of state buffers, and
    each batch signature (keys, shapes, dtypes, devices) has one set of
    static inputs.  A call runs the host part, copies the batch into its
    static inputs and runs the device part over the buffers, writing the
    new state into them after every read.  With CUDA buffers the device
    part is captured once per signature into a ``torch.cuda.CUDAGraph``
    and replayed: first a warm-up on a side stream (the whole step with its
    results dropped: it builds the kernels, raises their shared-memory
    limits, fills the plan caches and advances no buffer), then the
    capture.  A failed capture or replay raises; the step never falls
    back to running eagerly.  On the CPU, which has no graphs, the same device part runs
    uncaptured over the same buffers.

    ``donate=True``: the state passed in becomes the state buffers and the
    returned state holds the same storages, so the caller's state is
    consumed.  A state that holds other storages rebinds the buffers and
    drops the graphs (the next call captures again).  ``donate=False``:
    the state is copied into the buffers and left as it was, and the
    returned state is a copy.  ``load`` writes a state into the buffers (a
    restore) without rebinding them.

    Metrics come back as copies of the graph's outputs, on the device.
    ``captures`` counts the signatures set up (each a graph capture on the
    card), ``replays`` the graph replays; ``_cache_size()`` is the capture
    count, as a jitted function's cache size is its compile count.
    """

    def __init__(self, host: Callable, device: Callable, *, donate: bool = True):
        self.host = host
        self.device = device
        self.donate = bool(donate)
        self.donate_argnums = (0,) if donate else ()
        self.captures = 0
        self.replays = 0
        self._state: Optional[Tuple[Tree, Tree]] = None  # (params, opt_state)
        self._entries: Dict[Tuple, Dict[str, Any]] = {}

    def _cache_size(self) -> int:
        return self.captures

    def _bind(self, state: TrainState) -> None:
        given = (state.params, state.opt_state)
        if self._state is not None and same_storages(given, self._state):
            return  # the buffers themselves: updated in place
        if self.donate or self._state is None:
            self._state = given if self.donate else tree_map(torch.clone, given)
            self._entries.clear()  # a graph reads the buffers it captured
        else:
            _copy_into(self._state, given)

    def _export(self, step: int) -> TrainState:
        params, opt_state = self._state
        if not self.donate:
            params, opt_state = tree_map(torch.clone, (params, opt_state))
        return TrainState(params, opt_state, step)

    def load(self, state: TrainState) -> TrainState:
        """Write ``state`` into the state buffers (binding it where there
        are none yet); returns the state to pass to the next call."""
        if self._state is None:
            self._bind(state)
        else:
            _copy_into(self._state, (state.params, state.opt_state))
        return self._export(state.step)

    def _body(self, inputs: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The device part over the buffers, writing the new state into
        them leaf by leaf, each after its last read."""
        state = TrainState(*self._state, 0)
        return self.device(state, inputs, self._state)

    def _build(self, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        entry = {"inputs": {k: v.clone() for k, v in batch.items()},
                 "graph": None, "metrics": None}
        first = tree_leaves(self._state)[0]
        if first.is_cuda:
            cur = torch.cuda.current_stream(first.device)
            side = torch.cuda.Stream(first.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                # the whole step, its results dropped: no buffer advances
                # and no copy of the state is made
                self.device(TrainState(*self._state, 0), entry["inputs"],
                            None)
            cur.wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with contracts.no_collection(), torch.cuda.graph(graph):
                entry["metrics"] = self._body(entry["inputs"])
            entry["graph"] = graph
        self.captures += 1
        contracts.note_capture()
        return entry

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor]):
        batch = self.host(batch)
        self._bind(state)
        sig = tuple((k, tuple(v.shape), v.dtype, str(v.device))
                    for k, v in sorted(batch.items()))
        entry = self._entries.get(sig)
        if entry is None:
            entry = self._entries[sig] = self._build(batch)
        else:
            for k, buf in entry["inputs"].items():
                buf.copy_(batch[k])
        if entry["graph"] is None:
            metrics = self._body(entry["inputs"])
        else:
            entry["graph"].replay()
            self.replays += 1
            metrics = {k: v.clone() for k, v in entry["metrics"].items()}
        return self._export(state.step + 1), metrics


@dataclasses.dataclass
class StragglerWatchdog:
    """Wall-time monitor over whatever cadence the caller feeds it.  An
    observation above ``factor`` x the running median marks this host a
    straggler candidate.  ``Trainer.run`` feeds it the mean step time of
    each sync window, so a persistent slowdown trips it and a single slow
    step inside a window is diluted; ``warmup`` counts observations."""

    factor: float = 3.0
    warmup: int = 5
    _times: list = dataclasses.field(default_factory=list)

    def observe(self, dt: float) -> Optional[str]:
        self._times.append(dt)
        if len(self._times) <= self.warmup:
            return None
        hist = sorted(self._times[:-1])
        median = hist[len(hist) // 2]
        if dt > self.factor * median:
            return (
                f"straggler: step took {dt:.3f}s vs median {median:.3f}s "
                f"(x{dt / median:.1f})"
            )
        return None


class Trainer:
    """Checkpoint/restart-capable loop driving the step function: a
    ``StaticStep`` with ``jit=True`` (the default, as the reference's),
    the eager step with ``jit=False``."""

    def __init__(
        self,
        model,
        optimizer: Optimizer,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 100,
        keep_n: int = 3,
        accum_steps: int = 1,
        jit: bool = True,
        donate: bool = True,
    ):
        self.model = model
        self.optimizer = optimizer
        if jit:
            self.step_fn = StaticStep(
                *make_step_parts(model, optimizer, accum_steps), donate=donate
            )
        else:
            self.step_fn = make_train_step(model, optimizer, accum_steps)
        self.ckpt = (
            CheckpointManager(ckpt_dir, keep_n=keep_n, async_save=True)
            if ckpt_dir
            else None
        )
        self.ckpt_every = ckpt_every
        self.watchdog = StragglerWatchdog()
        # the run's seed rides in the checkpoint payload; init_state and
        # restore_or_init overwrite this placeholder
        self.rng = 0
        self._make_instruments()

    # ----------------------------------------------------- observability
    def _make_instruments(self) -> None:
        self.metrics = MetricsRegistry()
        self.trace = TraceRecorder(capacity=4096)
        m = self.metrics
        self._m_steps = m.counter("train.steps")
        self._m_windows = m.counter("train.windows")
        self._m_stragglers = m.counter("train.straggler_warnings")
        self._m_step_time = m.histogram("train.step_time_s", lo=1e-5, hi=1e4)
        self._m_loss = m.histogram("train.loss", lo=1e-6, hi=1e6)
        self._m_grad = m.histogram("train.grad_norm", lo=1e-9, hi=1e9)
        self.timeseries = TimeSeriesSampler(m, capacity=4096)

    def _record_window_metrics(
        self, metrics: Dict[str, float], window_steps: int, dt: float
    ) -> None:
        """Fold one sync window's observations into the registry:
        ``metrics`` is the last step's metric dict (host floats), ``dt``
        the window's mean per-step wall time.  ``train.metrics.*`` gauges
        carry the latest observation, equal to ``run()``'s returned
        metrics.  Subclasses add workload instruments."""
        self._m_steps.inc(window_steps)
        self._m_windows.inc()
        self._m_step_time.record(dt)
        if "loss" in metrics:
            self._m_loss.record(metrics["loss"])
        if "grad_norm" in metrics:
            self._m_grad.record(metrics["grad_norm"])
        for k, v in metrics.items():
            self.metrics.gauge(f"train.metrics.{k}").set(v)

    def export_obs(self, metrics_json=None, trace_out=None,
                   timeseries_out=None, log_fn=print) -> None:
        """Write whichever observability sidecars were requested: the
        registry snapshot (JSON), the Chrome trace, the time series
        (JSONL)."""
        if metrics_json:
            self.metrics.write_json(metrics_json)
            log_fn(f"train metrics snapshot -> {metrics_json}")
        if trace_out:
            self.trace.write(trace_out)
            log_fn(f"train trace ({len(self.trace)} spans) -> {trace_out}")
        if timeseries_out:
            self.timeseries.write_jsonl(timeseries_out)
            log_fn(
                f"train time series ({len(self.timeseries)} samples) -> "
                f"{timeseries_out}"
            )

    def init_state(self, seed: int) -> TrainState:
        self.rng = int(seed)
        params = self.model.init(self.rng)
        return TrainState(params, self.optimizer.init(params), 0)

    # ------------------------------------------------- checkpoint payload
    def _checkpoint_metric_names(self):
        """Lifetime counters persisted in the checkpoint payload, so a
        restored run continues its accounting."""
        return ["train.steps", "train.windows", "train.straggler_warnings"]

    def _ckpt_tree(self, state: TrainState) -> Dict:
        """The full resume state as one tree: params, optimizer state and
        step, the run's seed and the lifetime counters."""
        return {
            "state": state,
            "rng": self.rng,
            "metrics": {
                name: float(self.metrics.counter(name).value)
                for name in self._checkpoint_metric_names()
            },
        }

    def restore_or_init(self, seed: int) -> TrainState:
        """Resume from the newest intact checkpoint (a corrupt one falls
        back to the previous keep-N save), restoring params, optimizer
        state, step, seed and lifetime counters; init fresh from ``seed``
        when no usable checkpoint exists.  A ``StaticStep`` gets the state
        written into its buffers (``StaticStep.load``), so a graph it has
        captured trains on the restored values."""
        state = self.init_state(seed)
        if self.ckpt is not None:
            _, restored = self.ckpt.restore_latest(self._ckpt_tree(state))
            if restored is not None:
                self.rng = restored["rng"]
                for name, v in restored["metrics"].items():
                    c = self.metrics.counter(name)
                    c.inc(float(v) - c.value)
                state = restored["state"]
        if isinstance(self.step_fn, StaticStep):
            return self.step_fn.load(state)
        return state

    def run(
        self,
        state: TrainState,
        batches: Iterator[Dict[str, torch.Tensor]],
        num_steps: int,
        log_every: int = 10,
        log_fn=print,
    ) -> Tuple[TrainState, Dict[str, float]]:
        """Drive ``num_steps`` training steps.

        The host reads the device only at ``log_every`` sync windows (and
        the last step): the window's metrics come back in one transfer,
        which is also what waits for the device.  In between, steps are
        enqueued while earlier ones run.  The watchdog observes the mean
        step time of each window.
        """
        last_metrics: Dict[str, float] = {}
        step0 = int(state.step)
        t_window = time.perf_counter()
        window_steps = 0
        for i in range(num_steps):
            state, metrics = self.step_fn(state, next(batches))
            window_steps += 1
            step_no = step0 + i + 1
            if i % log_every == 0 or i == num_steps - 1:
                names = list(metrics)
                values = torch.stack(
                    [metrics[k].to(torch.float32) for k in names]
                ).tolist()  # the window's one device read
                t_now = time.perf_counter()
                dt = (t_now - t_window) / window_steps
                warn = self.watchdog.observe(dt)
                if warn:
                    log_fn(f"[watchdog] {warn}")
                    self._m_stragglers.inc()
                    self.trace.instant(
                        "straggler", t_now, track="train",
                        args={"step": step_no, "mean_step_s": dt},
                    )
                last_metrics = dict(zip(names, values))
                self._record_window_metrics(last_metrics, window_steps, dt)
                self.trace.span(
                    "window", t_window, t_now, track="train",
                    args={
                        "step": step_no,
                        "steps": window_steps,
                        "ms_per_step": dt * 1e3,
                        "loss": last_metrics.get("loss"),
                    },
                )
                self.timeseries.sample(t_now)
                t_window = time.perf_counter()
                window_steps = 0
                log_fn(
                    f"step {step_no}: "
                    + " ".join(f"{k}={v:.4f}" for k, v in last_metrics.items())
                    + f" ({dt * 1e3:.0f} ms/step)"
                )
            if self.ckpt is not None and step_no % self.ckpt_every == 0:
                self.ckpt.save(step_no, self._ckpt_tree(state))
        if self.ckpt is not None:
            self.ckpt.save(step0 + num_steps, self._ckpt_tree(state))
            self.ckpt.close()  # join the async writer before returning
        return state, last_metrics
