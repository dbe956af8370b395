"""GPipe-style pipeline parallelism over the devices of a mesh axis.

The counterpart of the reference's ``repro.distributed.pipeline``: the
layer-stacked params of a uniform group are split into S stages along the
stacked dim, and microbatches stream through the stages.  The schedule is
the reference's GPipe fill-drain over M microbatches, M + S - 1 ticks
(bubble fraction (S - 1)/(M + S - 1)): at tick t, stage s works on
microbatch t - s when that index is valid.

Where the reference runs one ``scan`` per device inside ``shard_map`` and
moves the boundary activation with ``ppermute`` (then ``psum``s the last
stage's outputs to every device), one PyTorch process drives every stage:
stage s holds ``stacked_params[s]`` on mesh device s, the boundary
activation moves to the next stage's device with a non-blocking copy, and
the last stage's outputs are gathered on the caller's device.  On distinct
cards each stage's work is queued on its own card, so the stages overlap
as the schedule intends; on one device repeated they run in turn.  The
result is what the reference computes.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch

from repro_torch.distributed.partitioning import Mesh
from repro_torch.tree import tree_map

Tree = Any


def pipeline_forward(
    fn: Callable[[Tree, torch.Tensor], torch.Tensor],
    mesh: Mesh,
    axis: str = "pipe",
):
    """Build a pipelined forward for a stage function.

    fn(stage_params, x) -> x  applies ONE stage (a chunk of layers) and
    keeps the activation's shape.  Returns
    pipe_fn(stacked_stage_params, microbatches) -> outputs where
      stacked_stage_params : leaves (S, ...)   (S = mesh.shape[axis])
      microbatches         : (M, mb, ...) input microbatches
      outputs              : (M, mb, ...) on the microbatches' device
    """
    if axis not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no {axis!r}")
    S = mesh.shape[axis]
    # stage s runs on the device at index s of ``axis`` (index 0 of any
    # other axis, whose devices would hold replicas)
    at = mesh.axis_names.index(axis)
    devices = [
        mesh.devices[tuple(s if i == at else 0
                           for i in range(len(mesh.axis_names)))]
        for s in range(S)
    ]

    def pipe_fn(stage_params: Tree, microbatches: torch.Tensor) -> torch.Tensor:
        M = microbatches.shape[0]
        if M < 1:
            raise ValueError("pipeline_forward needs at least one microbatch")
        local = [
            tree_map(lambda t, s=s: t[s].to(devices[s], non_blocking=True),
                     stage_params)
            for s in range(S)
        ]
        # buf[s]: the activation entering stage s at this tick
        buf: list[Optional[torch.Tensor]] = [None] * S
        outs: list[Optional[torch.Tensor]] = [None] * M
        for t in range(M + S - 1):
            # later stages first: each reads the activation its
            # predecessor produced at the previous tick
            for s in reversed(range(S)):
                m = t - s
                if not 0 <= m < M:
                    continue
                x = (microbatches[m].to(devices[0], non_blocking=True)
                     if s == 0 else buf[s])
                y = fn(local[s], x)
                if s == S - 1:
                    outs[m] = y.to(microbatches.device, non_blocking=True)
                else:
                    buf[s + 1] = y.to(devices[s + 1], non_blocking=True)
        return torch.stack(outs)

    return pipe_fn


def make_pipe_mesh(num_stages: int, device=None) -> Mesh:
    """A 1-D ``pipe`` mesh: the first ``num_stages`` CUDA devices, or the
    CPU repeated when ``device="cpu"``.  Raises when there are fewer
    cards than stages (build a :class:`Mesh` of one card repeated to run
    several stages on it)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return Mesh([torch.device("cpu")] * num_stages, ("pipe",))
    n = torch.cuda.device_count()
    if n < num_stages:
        raise ValueError(
            f"a {num_stages}-stage pipe mesh needs {num_stages} CUDA "
            f"devices, {n} found; pass device='cpu' or build a Mesh of a "
            f"repeated device"
        )
    return Mesh([torch.device("cuda", i) for i in range(num_stages)],
                ("pipe",))
