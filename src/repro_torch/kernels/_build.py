"""Build the port's CUDA kernels with ``nvcc`` and load them via ctypes.

Each ``csrc/<name>.cu`` exports a plain C launcher and compiles into its
own shared library under ``build/kernels/`` at the repository root, named
by a hash of the source so an edited kernel is never served stale.
``ptxas``'s report of the build (``-Xptxas=-v``: registers, spills and
static shared memory of each entry function) is kept beside the library
under the same name with a ``.ptxas.txt`` suffix, where
``analysis.kernel_budget`` reads it.  The build runs at first use, on the
machine with the card; importing this module compiles nothing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# -fmad=false: no multiply-add contraction anywhere, so a kernel's float
# arithmetic rounds exactly as its plain PyTorch version does
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas=-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C signature of each source's launcher: (symbol, argtypes)
SIGNATURES: Dict[str, Tuple[str, list]] = {
    "aer_matmul": (
        "aer_matmul_launch",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    ),
    "decode_attention": (
        "decode_attention_launch",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    ),
    "lif_fused": ("lif_fused_launch", [_P, _P, _P, _P, _P, _P, _I, _LL, _I, _I, _I, _P]),
    "mla_decode": (
        "mla_decode_launch",
        [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, ctypes.c_float, _P],
    ),
    "phase_marker": ("phase_marker_launch", [_I, _P]),
    "q115_matmul": ("q115_matmul_launch", [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]),
    "snn_chunk": (
        "snn_chunk_launch",
        [_P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _P,
         _LL, _LL, _LL, _LL, _I, _I, _I, _I, _I, _I, ctypes.c_float,
         _P, _P, _P, _P, _P, _I, _I, _I, _P],
    ),
    "spike_matmul": ("spike_matmul_launch", [_P, _P, _P, _I, _I, _I, _I, _P]),
}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the "
            "port's CUDA kernels are built from source at first use"
        )
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def ptxas_log_path(name: str) -> Path:
    """Where the ``ptxas`` report of ``name``'s library is kept."""
    return library_path(name).with_suffix(".ptxas.txt")


def _start(name: str):
    """Start ``nvcc`` for one source; returns (popen, tmp, out) or None
    when the library and its ``ptxas`` report are already built."""
    out = library_path(name)
    if out.exists() and ptxas_log_path(name).exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    report = ptxas_log_path(name)
    tmp_log = report.with_suffix(f".{os.getpid()}.tmp")
    tmp_log.write_text(log)
    os.replace(tmp_log, report)
    os.replace(tmp, out)
    return log


def build_all() -> Dict[str, Dict]:
    """Compile every kernel source at once (one ``nvcc`` each, in
    parallel).  Returns per-source {seconds, log}; raises after every
    ``nvcc`` has ended if any failed."""
    t0 = time.perf_counter()
    started = {name: _start(name) for name in SIGNATURES}
    report, errors = {}, []
    for name, job in started.items():
        try:
            log = "cached" if job is None else _finish(name, job)
        except RuntimeError as err:
            errors.append(str(err))
            continue
        report[name] = {"seconds": time.perf_counter() - t0, "log": log}
    if errors:
        raise RuntimeError("\n".join(errors))
    return report


@functools.lru_cache(maxsize=None)
def load(name: str):
    """The ctypes launcher of kernel ``name``, building it if needed."""
    job = _start(name)
    if job is not None:
        _finish(name, job)
    lib = ctypes.CDLL(str(library_path(name)))
    symbol, argtypes = SIGNATURES[name]
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
