"""Functional optimizers over trees of tensors (``repro_torch.tree``)
and learning-rate schedules, with the reference's arithmetic."""

from repro_torch.optim.adam import (
    AdamState,
    Optimizer,
    SGDState,
    adam,
    adamw,
    apply_updates,
    chain_clip,
    global_norm,
    sgd,
)
from repro_torch.optim.schedule import constant, cosine_decay, warmup_cosine

__all__ = [
    "AdamState",
    "Optimizer",
    "SGDState",
    "adam",
    "adamw",
    "sgd",
    "apply_updates",
    "chain_clip",
    "global_norm",
    "constant",
    "cosine_decay",
    "warmup_cosine",
]
