"""Atomic, checksummed checkpoints of trees of tensors."""

from repro_torch.checkpoint.manager import (
    CheckpointCorruptError,
    CheckpointManager,
    gc_orphan_tmpdirs,
    load_array_dir,
    publish_array_dir,
)

__all__ = [
    "CheckpointCorruptError",
    "CheckpointManager",
    "gc_orphan_tmpdirs",
    "load_array_dir",
    "publish_array_dir",
]
