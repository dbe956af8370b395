"""The PyTorch port stands alone: it imports neither JAX nor the
reference package, statically or at run time."""

import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"
]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_port_sources_import_no_jax_or_reference():
    assert len(PORT_FILES) > 15 and all(p.exists() for p in PORT_FILES)
    bad = [
        (str(p.relative_to(ROOT)), name)
        for p in PORT_FILES
        for name in _imported_modules(p)
        if _forbidden(name)
    ]
    assert bad == []


def test_importing_the_port_loads_no_jax_or_reference():
    mods = [
        "repro_torch." + ".".join(p.relative_to(ROOT / "src" / "repro_torch")
                                  .with_suffix("").parts)
        for p in PORT_FILES
        if p.name != "chip_smoke.py" and p.name != "__init__.py"
    ]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120,
    )
    assert out.returncode == 0, out.stderr


def test_scan_covers_the_event_input_baseline_and_example_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("core/bcnn.py", "core/energy.py", "events/capacity.py",
                "events/aer.py", "events/runtime.py", "launch/serve.py",
                "examples/_common.py", "examples/quickstart.py",
                "examples/collision_avoidance.py",
                "examples/event_stream_serving.py",
                "examples/refractory_ablation.py",
                "examples/coding_ablation.py"):
        assert f"src/repro_torch/{mod}" in names, mod


def test_scan_covers_the_contracts_and_the_graphed_trainer():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("analysis/__init__.py", "analysis/contracts.py",
                "analysis/torchlint.py", "analysis/kernel_budget.py",
                "analysis/__main__.py",
                "train/loop.py", "sparse_train/trainer.py",
                "sparse_train/event_layer.py", "launch/train.py"):
        assert f"src/repro_torch/{mod}" in names, mod


def test_scan_covers_the_lm_zoo_serving_path():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    archs = ("mixtral_8x7b", "granite_moe_1b_a400m", "mamba2_130m",
             "stablelm_1_6b", "codeqwen1_5_7b", "yi_34b", "minicpm3_4b",
             "recurrentgemma_2b", "phi_3_vision_4_2b", "musicgen_medium")
    for mod in (("models/__init__.py", "models/config.py", "models/layers.py",
                 "models/attention.py", "models/moe.py", "models/ssm.py",
                 "models/griffin.py", "models/transformer.py",
                 "models/model.py", "serving/engine.py",
                 "configs/__init__.py", "examples/serve_quantized_lm.py")
                + tuple(f"configs/{a}.py" for a in archs)):
        assert f"src/repro_torch/{mod}" in names, mod


def test_scan_covers_the_lm_training_path():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("data/tokens.py", "distributed/__init__.py",
                "distributed/compression.py", "optim/adam.py",
                "train/loop.py", "launch/train.py", "models/model.py",
                "models/transformer.py"):
        assert f"src/repro_torch/{mod}" in names, mod


def test_scan_covers_the_dry_run():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("launch/shapes.py", "launch/mesh.py", "launch/dryrun.py"):
        assert f"src/repro_torch/{mod}" in names, mod


def test_train_launcher_says_lm_training_is_ported():
    import repro_torch.launch.train as train

    assert "not ported" not in train.__doc__
    assert "--arch stablelm-1.6b" in train.__doc__
