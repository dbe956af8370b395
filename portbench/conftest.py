"""Set-up of the benchmark's own tests (``portbench/tests``), run from the
checkout's root or from ``portbench``.

The tests cut each cell of ``BENCHMARK.json`` to a tiny size from
``pb_tiny``'s tables; the cells added after those tables bring their cuts
in ``pb_tiny_cells``, merged here before any test module is collected.
"""

import os
import sys

_TESTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
if _TESTS not in sys.path:
    sys.path.insert(0, _TESTS)

import pb_tiny  # noqa: E402
import pb_tiny_cells  # noqa: E402

pb_tiny_cells.extend(pb_tiny)
