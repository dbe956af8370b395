import os
import sys

# make `import repro` work without PYTHONPATH=src
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# make `import _hypothesis_compat` work regardless of pytest rootdir mode
sys.path.insert(0, os.path.dirname(__file__))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skipped where there is none"
    )
