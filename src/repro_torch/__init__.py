"""PyTorch/CUDA port of the event-driven SNN system in ``repro``.

Plain tensor code is PyTorch; the fused chunk kernel is CUDA C++ for
Hopper (``kernels/csrc``), built at first use.  Public functions keep the
reference package's names, argument names and layouts.  The port imports
neither ``jax`` nor ``repro``.
"""
