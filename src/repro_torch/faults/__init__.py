"""Fault tolerance for the SNN serving stack.

Three cooperating pieces, consumed by ``serving.snn_engine``:

- :mod:`repro_torch.faults.shedding` — admission-plane load shedding
  (bounded-queue backpressure + EDF feasibility shedder).
- :mod:`repro_torch.faults.supervisor` — chunk-dispatch retry with
  capped backoff and fused->torch backend demotion.
- :mod:`repro_torch.faults.inject` — deterministic seeded fault
  injection (NaN membranes, corrupted rings, dispatch exceptions, tick
  stalls, process kills, corrupted snapshots) for the chaos tests and
  ``chip_smoke.py``'s fault phase.

The port's counterpart of ``repro.faults``, with the same exports;
nothing here imports JAX.
"""

from repro_torch.faults.inject import (  # noqa: F401
    FAULT_KINDS,
    Fault,
    FaultInjector,
    FaultSchedule,
    InjectedChunkError,
    corrupt_checkpoint,
)
from repro_torch.faults.shedding import (  # noqa: F401
    AdmissionPolicy,
    backpressure,
    feasibility,
)
from repro_torch.faults.supervisor import (  # noqa: F401
    ChunkDispatchError,
    ChunkSupervisor,
    RetryPolicy,
)

__all__ = [
    "AdmissionPolicy",
    "backpressure",
    "feasibility",
    "ChunkDispatchError",
    "ChunkSupervisor",
    "RetryPolicy",
    "FAULT_KINDS",
    "Fault",
    "FaultInjector",
    "FaultSchedule",
    "InjectedChunkError",
    "corrupt_checkpoint",
]
