"""Distributed helpers of the port: gradient compression, logical-axis
partitioning (meshes, specs, the serving engine's slot shards) and the
GPipe pipeline."""

from repro_torch.distributed import compression, partitioning, pipeline

__all__ = ["compression", "partitioning", "pipeline"]
