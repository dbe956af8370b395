"""Observability: metrics registry, span tracing and windowed time series.

Copies of the reference's jax-free ``obs.metrics``, ``obs.trace`` and
``obs.timeseries`` (the reference's ``obs`` package imports JAX through
its profiler, so the port carries its own).  Submodules are imported
explicitly.
"""
