"""Production and host meshes (``distributed.partitioning.Mesh``).

Defined as functions, never module-level constants, so importing this
module touches no device.

Production topology (the assignment's, 256 and 512 devices):
  single pod : (16, 16)    axes (data, model)        = 256 devices
  multi pod  : (2, 16, 16) axes (pod, data, model)   = 512 devices
    pod   : pure data parallelism (one cross-pod grad all-reduce a step)
    data  : FSDP + batch DP
    model : tensor parallel (heads / mlp / experts / vocab)

The production meshes hold ``torch.device("meta")`` at every position: the
dry run (``launch.dryrun``) plans a cell on them without a device or any
storage.  ``make_host_mesh`` lays out the devices this host has.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.partitioning import Mesh
from repro_torch.serving.snn_engine import resolve_device


def make_production_mesh(
    *,
    multi_pod: bool = False,
    shape: Optional[Tuple[int, ...]] = None,
    axes: Optional[Tuple[str, ...]] = None,
) -> Mesh:
    """The production mesh of ``meta`` devices.  ``shape``/``axes``
    override it (e.g. a (32, 8) data/model remap, or a small mesh for
    tests); the defaults are the assignment's meshes."""
    if shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
        axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if axes is None or len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} needs one axis name per dim, "
                         f"got {axes}")
    devices = np.empty(tuple(shape), dtype=object)
    devices.fill(torch.device("meta"))
    return Mesh(devices, axes)


def make_host_mesh(model: int = 1, device=None) -> Mesh:
    """This host's devices as a (n / model, model) mesh on (data, model).
    ``device=None``: the cards (raises without one); ``device="cpu"``: the
    CPU, one position."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [dev]
    data = max(len(devs) // model, 1)
    if data * model != len(devs):
        raise ValueError(f"{len(devs)} device(s) do not lay out as "
                         f"({data}, {model})")
    return Mesh(np.array(devs, dtype=object).reshape(data, model),
                ("data", "model"))
