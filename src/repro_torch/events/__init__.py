"""Event-driven (AER) input staging and the chunk runtime.

- ``aer``:      AER event streams, ``merge``, packed per-step event
                tables and address dtypes, the synthetic DVS camera.
- ``runtime``:  event extraction, gathered synaptic integration and the
                stateful chunk runner, with a plain backend and the
                fused-kernel backend (``kernels.snn_chunk``), and the
                AER-direct forward (``event_forward_aer``).
- ``capacity``: event-list capacity autotuning from measured per-step
                counts, and its truncation report.
"""
