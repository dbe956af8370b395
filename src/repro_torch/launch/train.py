"""Training launcher of the port: event-driven SNN training on the card.

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
per-window time series as JSONL.  Training of the language models
(``--arch``) is not ported yet.
"""

from __future__ import annotations

import argparse

from repro_torch.events import aer
from repro_torch.serving.snn_engine import resolve_device
from repro_torch.sparse_train import trainer as ev_trainer


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
        lr=args.lr,
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
    step = trainer.step_fn
    print(f"step: static buffers, donated, captures {step.captures}, graph "
          f"replays {step.replays}" + ("" if device.type == "cuda" else
                                       " (the CPU runs it uncaptured)"))
    trainer.export_obs(
        metrics_json=args.metrics_json,
        trace_out=args.trace_out,
        timeseries_out=args.timeseries_out,
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--snn-events", action="store_true",
                    help="train the SNN event-drivenly on synthetic DVS "
                         "collision streams (sparse_train)")
    ap.add_argument("--arch", default=None,
                    help="language-model training: not ported yet")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=float, default=5e-4,
                    help="learning rate (the paper's 5e-4)")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", default="auto", choices=["auto", "never"])
    ap.add_argument("--quant", default=None, choices=[None, "q115"])
    ap.add_argument("--seed", type=int, default=0)
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
    if args.arch is not None or not args.snn_events:
        raise NotImplementedError(
            "language-model training is not ported yet; pass --snn-events"
        )
    _train_snn_events(args)


if __name__ == "__main__":
    main()
