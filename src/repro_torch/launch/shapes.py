"""Assigned input shapes and per-(arch x shape) input specs.

Four LM shapes (assignment):
  train_4k    : seq 4096,   global batch 256   -> train step
  prefill_32k : seq 32768,  global batch 32    -> prefill
  decode_32k  : seq 32768,  global batch 128   -> decode step (1 new token)
  long_500k   : seq 524288, global batch 1     -> decode step; only runnable
                for sub-quadratic archs (SSM / hybrid / SWA): skips are
                recorded.

``batch_specs(cfg, shape)`` returns ``meta`` tensors of the reference's
shapes and dtypes plus logical axes for every model input: shardable,
no storage.  ``shape`` is a name in ``SHAPES`` or a ``ShapeSpec`` (a
cell the table does not list, such as a per-device batch).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import CLIP_EMBED_DIM, Model

META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def spec(shape: Union[str, ShapeSpec]) -> ShapeSpec:
    return shape if isinstance(shape, ShapeSpec) else SHAPES[shape]


def runnable(cfg: ModelConfig, shape: Union[str, ShapeSpec]) -> Tuple[bool, str]:
    """(runnable?, reason-if-skipped) for an (arch, shape) cell."""
    if spec(shape).name == "long_500k" and not cfg.sub_quadratic:
        return False, "skip(full-attn): 500k decode needs sub-quadratic attention"
    return True, ""


def _token_shape(cfg: ModelConfig, batch: int, seq: int):
    if cfg.num_codebooks:
        return (batch, seq, cfg.num_codebooks)
    return (batch, seq)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, shape: Union[str, ShapeSpec]):
    """``meta`` tensors + logical axes for the given cell's inputs.

    Returns (kind, inputs, axes); ``inputs`` are the step's data
    arguments, by name.
    """
    sp = spec(shape)
    B, L = sp.global_batch, sp.seq_len
    tok_axes = ("batch", "act_seq") + (("codebook",) if cfg.num_codebooks
                                       else ())

    if sp.kind in ("train", "prefill"):
        L_text = L - cfg.num_image_tokens
        inputs = {"tokens": _meta(_token_shape(cfg, B, L_text), torch.int32)}
        axes = {"tokens": tok_axes}
        if sp.kind == "train":
            inputs["targets"] = _meta(_token_shape(cfg, B, L_text), torch.int32)
            axes["targets"] = tok_axes
        if cfg.num_image_tokens:
            inputs["img_embeds"] = _meta(
                (B, cfg.num_image_tokens, CLIP_EMBED_DIM), torch.bfloat16)
            axes["img_embeds"] = ("batch", "act_seq", "clip")
        return sp.kind, inputs, axes

    # decode: one new token against a cache of length L
    inputs = {"token": _meta(_token_shape(cfg, B, 1), torch.int32),
              "pos": _meta((B,), torch.int32)}
    axes = {"token": tok_axes, "pos": ("batch",)}
    return "decode", inputs, axes


def abstract_cache(cfg: ModelConfig, shape: Union[str, ShapeSpec]):
    sp = spec(shape)
    return Model(cfg).abstract_cache(sp.global_batch, sp.seq_len)
