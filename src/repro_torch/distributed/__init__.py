"""Distributed training helpers of the port: gradient compression.  The
reference's partitioning and pipeline modules wait for multi-device
sharding."""

from repro_torch.distributed import compression

__all__ = ["compression"]
