"""Kernel build plumbing of the port, with a stand-in ``nvcc``: one
compile per source and flags, cached by content hash, failures raised
after every compile has ended.  (The real nvcc exists only on the
machine with the card.)"""

import pytest

from repro_torch.kernels import _build

PTXAS = "ptxas info    : Used 40 registers, used 1 barriers"


def _fake_cuda_home(tmp_path, body):
    bin_dir = tmp_path / "cuda" / "bin"
    bin_dir.mkdir(parents=True)
    nvcc = bin_dir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    return tmp_path / "cuda"


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    out = tmp_path / "build" / "kernels"
    monkeypatch.setattr(_build, "BUILD_DIR", out)
    return out


def test_build_all_compiles_each_source_once(tmp_path, monkeypatch, build_dir):
    writes_output = (
        'while [ $# -gt 0 ]; do\n'
        '  if [ "$1" = "-o" ]; then shift; echo built > "$1"; fi\n'
        '  shift\n'
        'done\n'
        f'echo "{PTXAS}"\n'
    )
    monkeypatch.setenv("CUDA_HOME", str(_fake_cuda_home(tmp_path, writes_output)))
    report = _build.build_all()
    assert set(report) == set(_build.SIGNATURES)
    assert PTXAS in report["snn_chunk"]["log"]
    lib = _build.library_path("snn_chunk")
    assert lib.parent == build_dir and lib.read_text() == "built\n"
    built = sorted(
        p.name for n in _build.SIGNATURES
        for p in (_build.library_path(n), _build.ptxas_log_path(n)))
    assert sorted(p.name for p in build_dir.iterdir()) == built  # no temp left
    # ptxas's report is kept beside the library, for kernel_budget
    assert PTXAS in _build.ptxas_log_path("snn_chunk").read_text()
    assert _build.build_all()["snn_chunk"]["log"] == "cached"
    # a library without its report builds again, so the report is there
    _build.ptxas_log_path("lif_fused").unlink()
    assert PTXAS in _build.build_all()["lif_fused"]["log"]
    assert _build.ptxas_log_path("lif_fused").exists()


def test_build_all_raises_nvcc_errors(tmp_path, monkeypatch, build_dir):
    monkeypatch.setenv(
        "CUDA_HOME", str(_fake_cuda_home(tmp_path, "echo 'error: boom'\nexit 1\n"))
    )
    with pytest.raises(RuntimeError, match="nvcc failed for snn_chunk.cu:\n.*boom"):
        _build.build_all()
    assert not _build.library_path("snn_chunk").exists()


def test_library_name_follows_source_and_flags(monkeypatch):
    name = _build.library_path("snn_chunk").name
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.library_path("snn_chunk").name != name
    assert name.startswith("libsnn_chunk-") and name.endswith(".so")


def test_every_kernel_source_is_built():
    """Each ``csrc/*.cu`` has a launcher signature, so ``build_all``
    compiles every kernel of the port (snn_chunk, aer_matmul, lif_fused,
    spike_matmul, q115_matmul)."""
    sources = {p.stem for p in _build.CSRC.glob("*.cu")}
    assert sources == set(_build.SIGNATURES)
    assert {"lif_fused", "spike_matmul", "q115_matmul"} <= sources
