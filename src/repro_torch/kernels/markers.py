"""Phase markers on the device's timeline.

``mark(phase, device)`` launches the empty kernel ``phase_marker_<phase>``
(``csrc/phase_marker.cu``) on ``device``'s current stream.  Inside a CUDA
graph capture the launch is recorded into the graph, so each replay shows
where the phase begins and ends in the profiler's trace by a kernel's
name, though the graph's other kernels share names across phases.  A
marker computes and writes nothing; on any other device ``mark`` does
nothing.  Where a body is captured, its first run is eager (a warm-up or
the signature's real first call), which loads the library and its kernels
before any capture.
"""

from __future__ import annotations

import torch

# the launcher's phase index is the position here (csrc: PHASE_MARKERS)
PHASES = ("prefill_begin", "prefill_end", "decode_begin", "decode_end",
          "update_begin", "update_end", "moe_begin", "moe_end", "mla_begin",
          "mla_end")
_INDEX = {p: i for i, p in enumerate(PHASES)}


def mark(phase: str, device: torch.device) -> None:
    """Launch ``phase``'s marker on ``device``'s current stream (a no-op off
    the card)."""
    i = _INDEX[phase]
    if device.type != "cuda":
        return
    from repro_torch.kernels import _build

    rc = _build.load("phase_marker")(
        i, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"phase marker {phase!r} launch failed: CUDA "
                           f"error {rc}")
