"""Serve a small LM with batched requests — optionally in the paper's
energy-aware Q1.15 quantized mode.

Prefill + step-synchronous batched decode with a KV cache, greedy, through
the same ``Model`` API and ``ServeEngine`` the full-width configs use.

  PYTHONPATH=src python -m repro_torch.examples.serve_quantized_lm [--q115] \\
      [--arch stablelm-1.6b] [--requests 8] [--new-tokens 24] [--batch 4] \\
      [--device cuda|cpu]
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.examples._common import add_device_flag
from repro_torch.models.model import Model
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.snn_engine import resolve_device


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--q115", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--batch", type=int, default=4)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = configs.get(args.arch).reduced(
        num_layers=4, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=2048,
    )
    if args.q115:
        cfg = dataclasses.replace(cfg, quant="q115")
    model = Model(cfg)
    params = model.init(0, device)
    n_params = model.param_count()
    print(f"arch={args.arch} (reduced) params={n_params/1e6:.1f}M "
          f"quant={cfg.quant}")

    engine = ServeEngine(model, params, batch_size=args.batch, cache_len=256)
    rng = np.random.default_rng(0)
    reqs = [
        Request(
            prompt=rng.integers(0, cfg.vocab_size, rng.integers(8, 32))
            .astype(np.int32),
            max_new_tokens=args.new_tokens,
        )
        for _ in range(args.requests)
    ]
    t0 = time.time()
    outs = engine.generate(reqs)
    dt = time.time() - t0
    total_new = sum(len(o) for o in outs)
    where = ("CPU" if device.type == "cpu"
             else torch.cuda.get_device_name(device))
    print(f"served {len(reqs)} requests, {total_new} new tokens "
          f"in {dt:.2f}s -> {total_new/dt:.1f} tok/s ({where})")
    for i, o in enumerate(outs[:3]):
        print(f"  req{i}: prompt_len={len(reqs[i].prompt)} -> {o[:10]}...")
    if cfg.quant == "q115":
        print("\nQ1.15 mode: weights snapped to the paper's fixed-point "
              "grid; int16 wire format halves weight bytes.")


if __name__ == "__main__":
    main()
