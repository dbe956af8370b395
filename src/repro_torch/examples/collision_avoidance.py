"""End-to-end driver: the paper's experiment at full scale.

Trains the paper's 4096-512-2 LIF SNN (25 time steps, Adam lr 5e-4,
dropout, CE summed over steps, §4.2) on 64x64 collision scenes with
checkpointing and auto-resume, evaluates train and test accuracy (a Table
1 row), and compares the LIF and Lapicque neuron models.

  PYTHONPATH=src python -m repro_torch.examples.collision_avoidance \\
      [--neuron lif|lapicque] [--image-hw 64] [--steps 300] [--seed 0] \\
      [--refractory 0] [--q115] [--ckpt DIR] [--device cpu]

Data, init, encoding and dropout all derive from ``--seed``, so a run
repeats; ``--steps`` counts optimizer steps, ``--num-steps`` the coding
window.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import snn
from repro_torch.data import collision
from repro_torch.examples import _common
from repro_torch.serving.snn_engine import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--neuron", default="lif", choices=["lif", "lapicque"])
    ap.add_argument("--image-hw", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=512)
    ap.add_argument("--num-steps", type=int, default=25,
                    help="SNN coding window (time steps)")
    ap.add_argument("--steps", type=int, default=300,
                    help="optimizer steps")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--num-train", type=int, default=4096)
    ap.add_argument("--num-test", type=int, default=1024)
    ap.add_argument("--refractory", type=int, default=0)
    ap.add_argument("--q115", action="store_true",
                    help="QAT: train with Q1.15 fake-quant weights")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed for data, init, encoding and dropout")
    ap.add_argument("--ckpt", default=None)
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = snn.SNNConfig(
        layer_sizes=(args.image_hw**2, args.hidden, 2),
        num_steps=args.num_steps,
        neuron_kind=args.neuron,
        refractory_steps=args.refractory,
        dropout_rate=0.2,
        quant_q115=args.q115,
    )
    print(f"config: {cfg}")
    trx, trY, tex, teY = collision.generate(collision.CollisionConfig(
        image_hw=args.image_hw, num_train=args.num_train,
        num_test=args.num_test, seed=args.seed,
    ))

    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = snn.init_params(torch.Generator().manual_seed(args.seed), cfg,
                             device)
    opt, train_step = _common.train_step_fn(cfg, _common.rate, gen)
    opt_state = opt.init(params)
    start_step = 0
    ckpt = CheckpointManager(args.ckpt, keep_n=2) if args.ckpt else None
    if ckpt:
        st, restored = ckpt.restore_latest(
            {"params": params, "opt": opt_state})
        if restored is not None:
            params, opt_state = restored["params"], restored["opt"]
            start_step = st
            print(f"resumed from step {st}")

    it, epoch = None, 0
    t0 = time.time()
    for step_no in range(start_step, args.steps):
        if it is None:
            it = collision.batches(trx, trY, args.batch, seed=epoch,
                                   device=device)
        try:
            x, y = next(it)
        except StopIteration:
            epoch += 1
            it = collision.batches(trx, trY, args.batch, seed=epoch,
                                   device=device)
            x, y = next(it)
        params, opt_state, loss, aux = train_step(params, opt_state, x, y)
        if step_no % 25 == 0 or step_no == args.steps - 1:
            dt = (time.time() - t0) / max(step_no - start_step + 1, 1)
            print(
                f"step {step_no:5d} loss={float(loss):7.3f} "
                f"acc={float(aux['accuracy']):.3f} "
                f"spike_rate={float(aux['spike_rate']):.4f} "
                f"({dt*1e3:.0f} ms/step on {device.type})", flush=True,
            )
        if ckpt and step_no and step_no % 100 == 0:
            ckpt.save(step_no, {"params": params, "opt": opt_state})

    # ---- evaluation (Table 1 row) ----------------------------------------
    def accuracy(x, y, seed, bs=128):
        g = torch.Generator(device=device).manual_seed(seed)
        correct = 0.0
        for s in range(0, len(x), bs):
            acc, _ = _common.evaluate(params, cfg, x[s:s + bs], y[s:s + bs],
                                      _common.rate, g, device)
            correct += acc * len(y[s:s + bs])
        return correct / len(x)

    tr_acc = accuracy(trx[:2048], trY[:2048], args.seed + 1)
    te_acc = accuracy(tex, teY, args.seed + 2)
    print(
        f"\nRESULT neuron={args.neuron} image={args.image_hw}px "
        f"refractory={args.refractory} q115={args.q115}: "
        f"train_acc={tr_acc:.3f} test_acc={te_acc:.3f}"
    )
    print("paper Table 1 (DroNet, for reference): "
          "LIF 64px: 92%/85%; Lapicque 64px: 95%/81%")
    if ckpt:
        ckpt.save(args.steps, {"params": params, "opt": opt_state})
        ckpt.close()


if __name__ == "__main__":
    main()
