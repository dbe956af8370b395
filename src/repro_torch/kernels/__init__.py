"""Hand-written Hopper kernels of the port and their plain PyTorch
versions.  CUDA sources live under ``csrc/`` and are built at first use
(``_build``); nothing here compiles or loads a kernel at import time."""
