"""EventTrainer: surrogate-gradient training over the event-driven path.

Reuses the training substrate in ``train/loop.py`` (step builder,
gradient accumulation, checkpointing, straggler watchdog, instruments) by
adapting the event-driven SNN to its model interface (``init(seed)`` /
``loss(params, batch)``).

The default workload is the synthetic DVS collision scenario: every batch
is freshly rendered by ``events.aer.dvs_collision_batch`` on the device,
converted to polarity-aware input planes, and trained with the
energy-aware loss.

  tcfg = EventTrainConfig(image_hw=64, hidden=512, num_steps=25,
                          polarity_mode="signed")
  t = EventTrainer(tcfg, use_kernel=True, device="cuda")
  state = t.init_state(0)
  state, metrics = t.run(state, dvs_batches(0, 32, tcfg, device="cuda"), 200)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from repro_torch.core import snn
from repro_torch.events import aer
from repro_torch.optim import adam, chain_clip
from repro_torch.serving.snn_engine import resolve_device
from repro_torch.sparse_train.event_layer import dropout_planes, event_eval_forward
from repro_torch.sparse_train.loss import event_loss_fn
from repro_torch.train import loop

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EventTrainConfig:
    """Static configuration of the event-driven training workload."""

    image_hw: int = 32
    num_steps: int = 15
    hidden: int = 128
    polarity_mode: str = "two_channel"  # aer.POLARITY_MODES
    dvs_capacity: Optional[int] = None  # event-list capacity per recording
    delta_threshold: float = 0.1
    dropout_rate: float = 0.0
    quant_q115: bool = False

    @property
    def num_pixels(self) -> int:
        return self.image_hw * self.image_hw

    @property
    def input_size(self) -> int:
        return aer.input_size_for(self.num_pixels, self.polarity_mode)

    @property
    def capacity(self) -> int:
        return self.dvs_capacity or 8 * self.num_pixels

    def snn_config(self) -> snn.SNNConfig:
        return snn.SNNConfig(
            layer_sizes=(self.input_size, self.hidden, 2),
            num_steps=self.num_steps,
            dropout_rate=self.dropout_rate,
            quant_q115=self.quant_q115,
        )


def _mix(seed: int, step: int) -> int:
    """A generator seed that depends only on (seed, step)."""
    state = np.random.SeedSequence([int(seed), int(step)]).generate_state(2)
    return int(state[0]) << 31 | int(state[1]) >> 1


class EventSNNModel:
    """Adapter: event-driven SNN -> the ``train.loop`` model interface.

    Batches are dicts with leading batch dims (so gradient accumulation's
    microbatch split works):
      spikes:    (B, T, K) input spike planes, on the device
      labels:    (B,) int64, on the device
      step_seed: (B,) int64 on the CPU, the data stream's step counter;
                 with the run ``seed`` it seeds the dropout generator
                 (unused when the config has no dropout)

    ``loss`` is two parts: ``prepare``, on the host, seeds the dropout
    generator from ``step_seed`` and draws the masks' uniforms into the
    batch (``dropout_u``, (B, T, hidden)); the rest reads the device only,
    so the trainer's ``StaticStep`` captures it in a CUDA graph and runs
    ``prepare`` before each replay.
    """

    def __init__(self, cfg: snn.SNNConfig, *, energy_lambda: float = 0.0,
                 use_kernel: bool = False, seed: int = 0, device=None):
        self.cfg = cfg
        self.energy_lambda = energy_lambda
        self.use_kernel = use_kernel
        self.seed = seed
        self.device = resolve_device(device)

    def init(self, seed: int):
        gen = torch.Generator().manual_seed(int(seed))
        return snn.init_params(gen, self.cfg, self.device)

    def param_count(self) -> int:
        sizes = self.cfg.layer_sizes
        # w + b + beta_raw + threshold
        return sum((fi + 3) * fo for fi, fo in zip(sizes[:-1], sizes[1:]))

    def prepare(self, batch: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """The host part of ``loss``: with dropout, the batch plus
        ``dropout_u``, the T uniform planes drawn from a generator seeded by
        ``(seed, step_seed[0])`` in the order the step-by-step draw takes
        them.  A batch that has them already is returned as it is."""
        if self.cfg.dropout_rate <= 0.0 or "dropout_u" in batch:
            return batch
        B, T = batch["spikes"].shape[:2]
        gen = torch.Generator(device=batch["spikes"].device).manual_seed(
            _mix(self.seed, int(batch["step_seed"][0]))
        )
        u = dropout_planes(gen, T, B, self.cfg.layer_sizes[1])
        return {**batch, "dropout_u": u.transpose(0, 1)}  # (B, T, hidden)

    def loss(self, params, batch: Dict[str, Tensor]):
        batch = self.prepare(batch)
        spikes = batch["spikes"].transpose(0, 1)  # (B,T,K) -> (T,B,K)
        train = self.cfg.dropout_rate > 0.0
        loss, metrics = event_loss_fn(
            params, spikes, batch["labels"], self.cfg,
            energy_lambda=self.energy_lambda, train=train,
            use_kernel=self.use_kernel,
            dropout_u=batch["dropout_u"].transpose(0, 1) if train else None,
        )
        metrics = dict(metrics)
        metrics["loss"] = loss.detach()
        return loss, metrics


class EventTrainer(loop.Trainer):
    """``train.loop.Trainer`` over the event-driven SNN.

    The model and the paper's Adam-5e-4 default optimizer are the only
    differences from the substrate.  On top of its instruments this
    registers the energy telemetry: per-layer measured spike-count
    counters (``train.events.l<i>.total``), a measured-energy counter
    (``train.energy_pj.total``) and per-inference event/energy histograms,
    accumulated from each sync window's observed per-inference metrics.

    ``use_kernel=True`` runs every layer's forward integration through
    the ``aer_spike_matmul_batched`` kernel (its plain version on the
    CPU).  ``device=None`` means the card, and raises without one.
    ``jit`` and ``donate`` are the substrate's, with the reference's
    defaults: on the card the step is one CUDA graph replay over state
    updated in place (``loop.StaticStep``).
    """

    def __init__(
        self,
        tcfg: EventTrainConfig,
        *,
        energy_lambda: float = 0.0,
        use_kernel: bool = False,
        lr: float = 5e-4,
        optimizer=None,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 100,
        accum_steps: int = 1,
        seed: int = 0,
        device=None,
        jit: bool = True,
        donate: bool = True,
    ):
        self.tcfg = tcfg
        self.snn_cfg = tcfg.snn_config()
        model = EventSNNModel(
            self.snn_cfg, energy_lambda=energy_lambda, use_kernel=use_kernel,
            seed=seed, device=device,
        )
        self.device = model.device
        opt = optimizer if optimizer is not None else chain_clip(adam(lr), 1.0)
        super().__init__(model, opt, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                         accum_steps=accum_steps, jit=jit, donate=donate)
        m = self.metrics
        self._m_layer_events = [
            m.counter(f"train.events.l{i}.total")
            for i in range(self.snn_cfg.num_layers)
        ]
        self._m_energy_total = m.counter("train.energy_pj.total")
        self._m_energy_hist = m.histogram(
            "train.energy_pj_per_inference", lo=1.0, hi=1e12
        )
        self._m_events_hist = m.histogram(
            "train.events_per_inference", lo=1.0, hi=1e9
        )

    def _checkpoint_metric_names(self):
        """The energy telemetry persists beside the substrate counters, so
        a resumed run's spike/energy trajectory continues."""
        return super()._checkpoint_metric_names() + [
            f"train.events.l{i}.total" for i in range(self.snn_cfg.num_layers)
        ] + ["train.energy_pj.total"]

    def _record_window_metrics(self, metrics, window_steps, dt):
        """Substrate instruments plus the spike/energy telemetry.  The
        counters accumulate one observation per sync window (a sampled
        integral); the gauges and histograms track the latest
        per-inference values."""
        super()._record_window_metrics(metrics, window_steps, dt)
        total_events = 0.0
        for i, c in enumerate(self._m_layer_events):
            ev = metrics.get(f"events_l{i}")
            if ev is not None and ev >= 0:
                c.inc(ev)
                total_events += ev
        if total_events > 0:
            self._m_events_hist.record(total_events)
        energy = metrics.get("energy_pj")
        if energy is not None:
            if energy >= 0:
                self._m_energy_total.inc(energy)
            self._m_energy_hist.record(energy)

    def evaluate(self, params, batch: Dict[str, Tensor], *, backend="auto"):
        """Inference-mode accuracy and measured events on the serving path
        (``event_layer.event_eval_forward``: the fused ``snn_chunk`` kernel
        on the card)."""
        spikes = batch["spikes"].transpose(0, 1)  # (B,T,K) -> (T,B,K)
        out_mem, out_spikes, events = event_eval_forward(
            params, spikes, self.snn_cfg, backend=backend
        )
        pred = snn.predict_from_traces(out_mem, out_spikes)
        return {
            "accuracy": torch.mean((pred == batch["labels"]).to(torch.float32)),
            "events_per_layer": torch.mean(events, dim=1),
            "predictions": pred,
        }


def dvs_batches(
    seed: int,
    batch_size: int,
    tcfg: EventTrainConfig,
    start_step: int = 0,
    device=None,
) -> Iterator[Dict[str, Tensor]]:
    """Endless stream of freshly rendered DVS collision batches.

    Each batch renders ``batch_size`` synthetic recordings on ``device``
    (``None`` means the card), AER-encodes their brightness changes and
    maps ON/OFF polarities onto the input layer per ``tcfg.polarity_mode``.
    Batch ``step``'s draws depend only on ``(seed, step)``, so a run
    resumed at ``start_step`` sees the same batches as an uninterrupted
    one.
    """
    dev = resolve_device(device)
    step = int(start_step)
    while True:
        gen = torch.Generator(device=dev).manual_seed(_mix(seed, step))
        stream, labels = aer.dvs_collision_batch(
            gen,
            batch_size,
            image_hw=tcfg.image_hw,
            num_steps=tcfg.num_steps,
            capacity=tcfg.capacity,
            delta_threshold=tcfg.delta_threshold,
        )
        planes = aer.input_planes(
            stream, tcfg.num_steps, tcfg.num_pixels,
            polarity_mode=tcfg.polarity_mode,
        )  # (T, B, K)
        yield {
            "spikes": planes.transpose(0, 1),
            "labels": labels,
            "step_seed": torch.full((batch_size,), step, dtype=torch.int64),
        }
        step += 1
