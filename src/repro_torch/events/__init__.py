"""Event-driven (AER) input staging and the chunk runtime.

- ``aer``:      packed per-step event tables and address dtypes.
- ``runtime``:  event extraction, gathered synaptic integration and the
                stateful chunk runner, with a plain backend and the
                fused-kernel backend (``kernels.snn_chunk``).
- ``capacity``: the layer-0 staging capacity.
"""
