"""Training launcher of the port, on the card: any arch of the LM zoo (the
default, ``stablelm-1.6b`` at full width) or the paper's SNN.

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \
      [--reduced] [--seq 128] [--batch 4] [--steps 50] [--quant q115] \
      [--ckpt DIR --resume auto]

trains the arch on the synthetic Markov token stream (``data.tokens``;
codebook streams repeat the tokens, the vlm gets random CLIP patch
embeddings) with the reference's chain, ``chain_clip(adamw(warmup_cosine
(lr, 10, max(steps, 11))), 1.0)``, lr 3e-4 unless ``--lr`` is given.
Params are float32, drawn on the card from seed 0, compute in the arch's
dtype (bfloat16 at full width), each layer-group repeat rematerialised as
``cfg.remat`` says.

  PYTHONPATH=src python -m repro_torch.launch.train --snn-events \
      --image-hw 64 --hidden 512 --snn-steps 25 --polarity signed \
      --batch 32 --steps 100 [--energy-lambda 0.05] [--ckpt DIR]

trains the paper's 4096-512-2 network with surrogate gradients through the
event path, every layer's forward integration through the
``aer_spike_matmul_batched`` CUDA kernel, on synthetic DVS collision
batches rendered on the card.  The trainer keeps the reference's
defaults (``jit=True, donate=True``): each step is one CUDA graph replay
over state updated in place.  It runs on the card and raises without a
GPU unless ``--device cpu`` is given (small sizes only: there the kernel's
plain version walks events one at a time).  With ``--ckpt`` and
``--resume auto`` it resumes from the newest intact checkpoint, on the
same batches an uninterrupted run would see.

``--metrics-json`` dumps the trainer's registry snapshot, ``--trace-out``
the per-window spans as Chrome trace JSON, ``--timeseries-out`` the
per-window time series as JSONL.
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch import configs
from repro_torch.data.tokens import MarkovTokenStream, TokenStreamConfig
from repro_torch.events import aer
from repro_torch.models.model import CLIP_EMBED_DIM, Model
from repro_torch.optim import adamw, chain_clip, warmup_cosine
from repro_torch.serving.snn_engine import resolve_device
from repro_torch.sparse_train import trainer as ev_trainer
from repro_torch.train.loop import Trainer


def batches(cfg, batch_size, seq_len, device=None):
    """The reference launcher's LM batches on ``device`` (None: the card):
    the Markov stream's (inputs, targets), stacked once per codebook for a
    codebook arch; a vlm's image embeddings from ``default_rng(0)``."""
    dev = resolve_device(device)
    stream = MarkovTokenStream(
        TokenStreamConfig(
            vocab_size=cfg.vocab_size, seq_len=seq_len, batch_size=batch_size
        )
    )
    rng = np.random.default_rng(0)
    for x, y in stream.batches():
        if cfg.num_codebooks:
            x = np.stack([x] * cfg.num_codebooks, -1)
            y = np.stack([y] * cfg.num_codebooks, -1)
        b = {"tokens": torch.as_tensor(x).to(dev),
             "targets": torch.as_tensor(y).to(dev)}
        if cfg.num_image_tokens:
            b["img_embeds"] = torch.as_tensor(
                rng.normal(0, 1, (batch_size, cfg.num_image_tokens,
                                  CLIP_EMBED_DIM)).astype(np.float32)
            ).to(dev)
        yield b


def lm_optimizer(lr, steps):
    """The reference launcher's LM optimizer: AdamW on a warm-up cosine
    schedule (10 warm-up steps), global-norm clipping at 1.0."""
    return chain_clip(adamw(warmup_cosine(lr, 10, max(steps, 11))), 1.0)


def _print_step(trainer, device) -> None:
    step = trainer.step_fn
    print(f"step: static buffers, donated, captures {step.captures}, graph "
          f"replays {step.replays}" + ("" if device.type == "cuda" else
                                       " (the CPU runs it uncaptured)"))


def _export(trainer, args) -> None:
    trainer.export_obs(
        metrics_json=args.metrics_json,
        trace_out=args.trace_out,
        timeseries_out=args.timeseries_out,
    )


def _train_snn_events(args) -> None:
    device = resolve_device(args.device)
    tcfg = ev_trainer.EventTrainConfig(
        image_hw=args.image_hw,
        num_steps=args.snn_steps,
        hidden=args.hidden,
        polarity_mode=args.polarity,
        quant_q115=(args.quant == "q115"),
    )
    trainer = ev_trainer.EventTrainer(
        tcfg,
        energy_lambda=args.energy_lambda,
        use_kernel=True,
        lr=args.lr if args.lr is not None else 5e-4,
        ckpt_dir=args.ckpt,
        ckpt_every=25,
        accum_steps=args.accum,
        seed=args.seed,
        device=device,
    )
    print(
        f"snn-events: {tcfg.input_size}-{tcfg.hidden}-2 "
        f"(dvs {tcfg.image_hw}x{tcfg.image_hw}, "
        f"polarity={tcfg.polarity_mode}, T={tcfg.num_steps}, "
        f"energy_lambda={args.energy_lambda}, "
        f"params={trainer.model.param_count() / 1e3:.1f}K, on {device})"
    )
    if args.ckpt and args.resume == "auto":
        state = trainer.restore_or_init(args.seed)
        if state.step:
            print(f"resumed at step {state.step}")
    else:
        state = trainer.init_state(args.seed)
    state, metrics = trainer.run(
        state,
        ev_trainer.dvs_batches(
            args.seed, args.batch, tcfg, start_step=state.step, device=device
        ),
        args.steps,
    )
    print("final:", metrics)
    _print_step(trainer, device)
    _export(trainer, args)


def _train_lm(args) -> None:
    device = resolve_device(args.device)
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.quant:
        cfg = dataclasses.replace(cfg, quant=args.quant)
    model = Model(cfg, device)
    print(f"arch={args.arch} params={model.param_count() / 1e6:.1f}M "
          f"(active {model.active_param_count() / 1e6:.1f}M)")
    opt = lm_optimizer(args.lr if args.lr is not None else 3e-4, args.steps)
    trainer = Trainer(
        model, opt, ckpt_dir=args.ckpt, ckpt_every=25, accum_steps=args.accum
    )
    if args.ckpt and args.resume == "auto":
        state = trainer.restore_or_init(0)
        if state.step:
            print(f"resumed at step {state.step}")
    else:
        state = trainer.init_state(0)
    state, metrics = trainer.run(
        state, batches(cfg, args.batch, args.seq, device), args.steps
    )
    print("final:", metrics)
    _print_step(trainer, device)
    _export(trainer, args)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b",
                    choices=configs.ARCH_IDS)
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=None,
                    help="learning rate (default: 3e-4 for LM archs, the "
                         "paper's 5e-4 for --snn-events)")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", default="auto", choices=["auto", "never"])
    ap.add_argument("--quant", default=None, choices=[None, "q115"])
    ap.add_argument("--seed", type=int, default=0)
    # event-driven SNN training mode
    ap.add_argument("--snn-events", action="store_true",
                    help="train the SNN event-drivenly on synthetic DVS "
                         "collision streams (sparse_train)")
    ap.add_argument("--image-hw", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--snn-steps", type=int, default=15,
                    help="SNN coding window (time steps)")
    ap.add_argument("--energy-lambda", type=float, default=0.0,
                    help="weight of the energy regularizer (loss/nJ)")
    ap.add_argument("--polarity", default="two_channel",
                    choices=list(aer.POLARITY_MODES),
                    help="how DVS ON/OFF events map onto input weights")
    ap.add_argument("--metrics-json", default=None,
                    help="write the trainer's metrics-registry snapshot")
    ap.add_argument("--trace-out", default=None,
                    help="write per-window train spans as Chrome trace JSON")
    ap.add_argument("--timeseries-out", default=None,
                    help="write the per-window time series as JSONL")
    args = ap.parse_args(argv)
    if args.snn_events:
        _train_snn_events(args)
    else:
        _train_lm(args)


if __name__ == "__main__":
    main()
