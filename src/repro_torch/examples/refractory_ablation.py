"""Refractory-period ablation (paper §4.2.2).

Trains the same reduced SNN with refractory periods {0, 2, 5, 8} and
reports accuracy and spike rate, the energy angle: the refractory period
caps each neuron's firing rate, which in the event-driven hardware (the
cascaded adder integrates active synapses only) sets the energy per
inference (``core.energy``, a 45 nm model estimate).

  PYTHONPATH=src python -m repro_torch.examples.refractory_ablation \\
      [--refractory 0 2 5 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.core import energy, snn
from repro_torch.data import collision
from repro_torch.examples import _common
from repro_torch.serving.snn_engine import resolve_device


def train_eval(cfg, data, args, device):
    trx, trY, tex, teY = data
    params, gen = _common.train(
        cfg, trx, trY, epochs=args.epochs, batch=args.batch, seed=args.seed,
        device=device, encode=_common.rate)
    acc, spikes = _common.evaluate(params, cfg, tex, teY, _common.rate, gen,
                                   device)
    rates = snn.hidden_spike_rates(params, spikes, cfg).tolist()
    layer_rates = [float(spikes.mean())] + rates[:-1]
    e_pj = energy.snn_inference_ops(
        cfg.layer_sizes, cfg.num_steps, layer_rates).energy_pj()
    return acc, layer_rates, e_pj


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--refractory", type=int, nargs="+", default=[0, 2, 5, 8])
    ap.add_argument("--image-hw", type=int, default=32)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--steps", type=int, default=20,
                    help="SNN coding window (time steps)")
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--num-train", type=int, default=1024)
    ap.add_argument("--num-test", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    _common.add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    base = snn.SNNConfig(layer_sizes=(args.image_hw**2, args.hidden, 2),
                         num_steps=args.steps, dropout_rate=0.2)
    data = collision.generate(collision.CollisionConfig(
        image_hw=args.image_hw, num_train=args.num_train,
        num_test=args.num_test))
    print("refractory | test_acc | hidden_rate | energy/inf (nJ)")
    base_energy = None
    for r in args.refractory:
        cfg = dataclasses.replace(base, refractory_steps=r)
        acc, rates, e_pj = train_eval(cfg, data, args, device)
        if base_energy is None:
            base_energy = e_pj
        print(f"{r:10d} | {acc:8.3f} | {rates[1]:11.4f} | "
              f"{e_pj/1e3:9.2f}  ({e_pj/base_energy:.2f}x)")
    print("\npaper §4.2.2 uses refractory=5; the table quantifies the "
          "accuracy/energy trade the hardware design exploits.")


if __name__ == "__main__":
    main()
