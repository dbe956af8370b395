"""Event-list capacity for staging resident inputs.

Only ``input_capacity`` is ported so far; the autotuner (measured
per-step spike-count percentiles) comes with a later slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.core import snn
from repro_torch.events import runtime


def input_capacity(
    cfg: snn.SNNConfig, capacities: Optional[Sequence[int]] = None
) -> int:
    """Layer-0 per-step event-list capacity: the explicit plan's first
    entry, full fan-in otherwise.  Validated as ``run_chunk`` validates
    ``capacities``, so a bad plan fails at engine init."""
    return runtime._resolve_capacities(cfg, capacities)[0]
