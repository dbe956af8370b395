"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON result line last.  Everything a cell is made of is found
by name: its configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``, read by the driver its ``kind`` names,
``drivers/<kind>.py``) and each per-layer metric (``metrics/<name>.py``).
"""
