"""The SNN examples, each runnable as ``python -m
repro_torch.examples.<name>`` and callable as ``main(argv)``:

- ``quickstart``: rate coding, a short training run, and the Fig. 5
  hardware path (``spike_matmul`` + ``lif_fused``) on the trained weights;
- ``collision_avoidance``: the paper's 4096-512-2 experiment with
  checkpointing, LIF or Lapicque;
- ``event_stream_serving``: the streaming engine on mixed rate-coded and
  DVS traffic, reported from its observability layer;
- ``refractory_ablation`` and ``coding_ablation``: accuracy, spike rates
  and modelled energy across refractory periods and input codes.

Defaults are the reference examples' sizes; flags shrink them.  Each runs
on the card unless ``--device cpu`` is given.
"""
