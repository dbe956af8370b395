"""Event-driven surrogate-gradient training of the SNN.

- ``event_layer``: ``event_linear`` (gathered-rows forward through the
  ``aer_spike_matmul_batched`` kernel, event-set weight gradient), BPTT
  over time (``event_bptt_forward``) and inference on the chunk runtime
  (``event_eval_forward``).
- ``loss``: the energy-aware objective and measured-energy metrics.
- ``trainer``: ``EventTrainer`` on the ``train.loop`` substrate, over
  synthetic DVS collision batches (``dvs_batches``).

Submodules are imported explicitly.
"""
