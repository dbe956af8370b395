"""Input-coding ablation (paper §3.2): rate vs TTFS vs deterministic rate.

The paper chooses Bernoulli rate coding "for its simplicity and
robustness"; this ablation quantifies the choice on the collision task:
accuracy, input spike rate (the event-driven energy driver) and energy
per inference (``core.energy``, a 45 nm model estimate).

  PYTHONPATH=src python -m repro_torch.examples.coding_ablation [--device cpu]
"""

from __future__ import annotations

import argparse

from repro_torch.core import coding, energy, snn
from repro_torch.data import collision
from repro_torch.examples import _common
from repro_torch.serving.snn_engine import resolve_device

ENCODERS = {
    "rate (paper)": _common.rate,
    "rate_deterministic":
        lambda gen, x, T: coding.rate_encode_deterministic(x, T),
    "ttfs": lambda gen, x, T: coding.ttfs_encode(x, T),
}


def train_eval(cfg, encode, data, args, device):
    trx, trY, tex, teY = data
    params, gen = _common.train(
        cfg, trx, trY, epochs=args.epochs, batch=args.batch, seed=args.seed,
        device=device, encode=encode)
    acc, spikes = _common.evaluate(params, cfg, tex, teY, encode, gen, device)
    in_rate = float(spikes.mean())
    rates = snn.hidden_spike_rates(params, spikes, cfg).tolist()
    e_pj = energy.snn_inference_ops(
        cfg.layer_sizes, cfg.num_steps, [in_rate] + rates[:-1]).energy_pj()
    return acc, in_rate, e_pj


def main(argv=None):
    ap = argparse.ArgumentParser()
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

    cfg = snn.SNNConfig(layer_sizes=(args.image_hw**2, args.hidden, 2),
                        num_steps=args.steps, dropout_rate=0.2)
    data = collision.generate(collision.CollisionConfig(
        image_hw=args.image_hw, num_train=args.num_train,
        num_test=args.num_test))
    print(f"{'encoder':20s} | test_acc | input_rate | energy/inf (nJ)")
    for name, enc in ENCODERS.items():
        acc, rate, e_pj = train_eval(cfg, enc, data, args, device)
        print(f"{name:20s} | {acc:8.3f} | {rate:10.4f} | {e_pj/1e3:10.2f}")
    print("\nTTFS emits at most one spike per pixel (T-fold fewer input "
          "events), the energy-optimal code when accuracy holds; the "
          "paper's rate coding is the robust default.")


if __name__ == "__main__":
    main()
