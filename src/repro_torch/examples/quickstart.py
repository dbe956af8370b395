"""Quickstart: the paper's pipeline in one run.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

1. renders a synthetic collision-avoidance scene (DroNet analog),
2. rate-codes it into Bernoulli spike trains (paper Fig. 2),
3. trains the LIF SNN (paper Fig. 4, reduced) for a few epochs,
4. reports its test accuracy,
5. runs the same weights through the hardware path (Q1.15
   ``spike_matmul`` + fused LIF kernels: the CUDA kernels on the card,
   their plain versions on the CPU).

The flags shrink the run (image size, hidden width, steps, epochs,
sample counts); the defaults are the reference example's.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.core import coding, snn
from repro_torch.data import collision
from repro_torch.examples import _common
from repro_torch.serving.snn_engine import resolve_device
from repro_torch.kernels import ops


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--image-hw", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--steps", type=int, default=15,
                    help="SNN coding window (time steps)")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--num-train", type=int, default=1024)
    ap.add_argument("--num-test", type=int, default=256)
    ap.add_argument("--hw-samples", type=int, default=64,
                    help="test samples run through the hardware path")
    ap.add_argument("--seed", type=int, default=0)
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # --- 1. data ---------------------------------------------------------
    trx, trY, tex, teY = collision.generate(collision.CollisionConfig(
        image_hw=args.image_hw, num_train=args.num_train,
        num_test=args.num_test, seed=args.seed,
    ))
    print(f"dataset: {trx.shape} train, {tex.shape} test, "
          f"P(collision)={trY.mean():.2f}")

    # --- 2. rate coding (paper §3.2) --------------------------------------
    cfg = snn.SNNConfig(layer_sizes=(args.image_hw**2, args.hidden, 2),
                        num_steps=args.steps, dropout_rate=0.2)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    demo = coding.rate_encode(
        gen, torch.as_tensor(trx[0].ravel()).to(device), cfg.num_steps)
    print(f"rate coding: pixel intensity {trx[0].mean():.2f} -> "
          f"mean spike rate {float(demo.mean()):.2f} over {cfg.num_steps} "
          f"steps")

    # --- 3/4. train the SNN (Adam lr 5e-4, CE summed over steps) ----------
    def log(epoch, loss, acc):
        print(f"epoch {epoch}: loss={loss:.3f} acc={acc:.3f}")

    params, gen = _common.train(
        cfg, trx, trY, epochs=args.epochs, batch=args.batch, seed=args.seed,
        device=device, encode=_common.rate, log=log)
    acc, spikes = _common.evaluate(params, cfg, tex, teY, _common.rate, gen,
                                   device)
    print(f"test accuracy (float model): {acc:.3f}")

    # --- 5. hardware path (paper §4.3) -------------------------------------
    n = min(args.hw_samples, len(tex))
    h = spikes[:, :n]
    for i in range(cfg.num_layers):
        lp = params[f"layer{i}"]
        h = ops.snn_layer_forward(
            h, lp["w"], lp["b"], snn.effective_beta(lp), lp["threshold"]
        )
    pred_hw = h.sum(dim=0).argmax(dim=-1).cpu().numpy()
    acc_hw = float((pred_hw == teY[:n]).mean())
    where = "CUDA kernels" if device.type == "cuda" else "plain versions"
    print(f"test accuracy (Q1.15 hardware path, {where}): {acc_hw:.3f}")


if __name__ == "__main__":
    main()
