"""Synthetic collision-avoidance dataset (DroNet availability gate).

The paper trains on ~32k annotated images labelled collision / no-collision
(DroNet, Loquercio et al. 2018).  That dataset is not available offline, so
this module procedurally renders scenes whose label depends on obstacle
*proximity* — the actual visual cue a collision classifier learns:

  - collision (label 1): a large obstacle (rect/ellipse/triangle) occupying
    a large fraction of the frame near the center line (close object).
  - no-collision (label 0): empty road, or small/peripheral obstacles
    (distant objects), same textures.

Scenes include a brightness-graded ground plane, perspective "road" edges,
Gaussian noise, and random global illumination so the task is non-trivial;
preprocessing matches the paper: grayscale, HxW in {32,64,128}, values
normalized to [0,1].

Generation is numpy-seeded, so this copy produces the reference's
images bit for bit; only ``batches`` differs, yielding torch tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CollisionConfig:
    image_hw: int = 64
    num_train: int = 4096
    num_test: int = 1024
    seed: int = 0
    noise_std: float = 0.05


def _render_scene(rng: np.random.Generator, hw: int, label: int) -> np.ndarray:
    """Render one grayscale scene in [0,1]."""
    img = np.zeros((hw, hw), dtype=np.float32)

    # sky/ground gradient + illumination
    illum = rng.uniform(0.5, 1.0)
    horizon = int(hw * rng.uniform(0.35, 0.55))
    ys = np.arange(hw)[:, None]
    img += np.where(ys < horizon, 0.75, 0.35).astype(np.float32)
    img[horizon:] += np.linspace(0.0, 0.25, hw - horizon)[:, None]

    # perspective road edges (light lines converging at the horizon)
    vx = hw // 2 + rng.integers(-hw // 8, hw // 8)
    for sign in (-1, 1):
        x0 = hw // 2 + sign * int(hw * rng.uniform(0.3, 0.48))
        for y in range(horizon, hw):
            t = (y - horizon) / max(hw - horizon, 1)
            x = int(vx + (x0 - vx) * t)
            if 0 <= x < hw:
                img[y, max(x - 1, 0) : min(x + 1, hw)] += 0.15

    def draw_obstacle(cx, cy, size, dark):
        kind = rng.integers(0, 3)
        yy, xx = np.mgrid[0:hw, 0:hw]
        if kind == 0:  # rectangle
            m = (np.abs(xx - cx) < size) & (np.abs(yy - cy) < size * 1.3)
        elif kind == 1:  # ellipse
            m = ((xx - cx) / max(size, 1)) ** 2 + (
                (yy - cy) / max(size * 1.2, 1)
            ) ** 2 < 1.0
        else:  # triangle-ish wedge
            m = (np.abs(xx - cx) < (yy - (cy - size * 1.3)) * 0.6) & (
                yy > cy - size * 1.3
            ) & (yy < cy + size * 1.3)
        img[m] = dark

    if label == 1:
        # close obstacle: large, near-center, low on the frame
        size = int(hw * rng.uniform(0.18, 0.33))
        cx = hw // 2 + rng.integers(-hw // 6, hw // 6 + 1)
        cy = int(hw * rng.uniform(0.55, 0.8))
        draw_obstacle(cx, cy, size, dark=rng.uniform(0.02, 0.18))
    else:
        # 0-2 distant/peripheral obstacles: small or far to the side
        for _ in range(int(rng.integers(0, 3))):
            size = int(hw * rng.uniform(0.03, 0.08))
            side = rng.integers(0, 2)
            cx = (
                rng.integers(0, hw // 5)
                if side == 0
                else rng.integers(4 * hw // 5, hw)
            )
            cy = int(hw * rng.uniform(0.45, 0.7))
            draw_obstacle(cx, cy, size, dark=rng.uniform(0.05, 0.25))

    img *= illum
    img += rng.normal(0.0, 0.05, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def generate(cfg: CollisionConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (train_x, train_y, test_x, test_y); x: (N,H,W) in [0,1]."""
    rng = np.random.default_rng(cfg.seed)
    n = cfg.num_train + cfg.num_test
    labels = rng.integers(0, 2, size=n).astype(np.int32)
    imgs = np.stack(
        [_render_scene(rng, cfg.image_hw, int(l)) for l in labels]
    ).astype(np.float32)
    tr, te = cfg.num_train, cfg.num_test
    return imgs[:tr], labels[:tr], imgs[tr : tr + te], labels[tr : tr + te]


def batches(
    x: np.ndarray,
    y: np.ndarray,
    batch_size: int,
    *,
    seed: int = 0,
    shuffle: bool = True,
    device=None,
) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Epoch iterator yielding tensors (flattened images) on ``device``."""
    rng = np.random.default_rng(seed)
    idx = np.arange(len(x))
    if shuffle:
        rng.shuffle(idx)
    for s in range(0, len(x) - batch_size + 1, batch_size):
        sel = idx[s : s + batch_size]
        yield (
            torch.as_tensor(x[sel].reshape(len(sel), -1)).to(device),
            torch.as_tensor(y[sel]).to(device),
        )
