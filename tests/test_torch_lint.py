"""The port's static analysis: per-rule lint fixtures of ``torchlint`` (the
counterpart of the reference's ``jaxlint``) in CUDA graph terms, the
suppression syntax, hazards planted in the five real graph bodies, the
Hopper kernel budgets with and without a ``ptxas`` report, the repo-wide
zero-findings invariant and the ``python -m repro_torch.analysis`` CLI,
which loads no JAX."""

import json
import pathlib
import subprocess
import sys

import pytest

from repro_torch.analysis import (
    DEFAULT_SMEM_BUDGET,
    RULES,
    check_kernel_budgets,
    lint_paths,
    lint_source,
)
from repro_torch.analysis import kernel_budget
from repro_torch.analysis.kernel_budget import KERNEL_PLANNERS
from repro_torch.kernels import _build

ROOT = pathlib.Path(__file__).resolve().parents[1]


def codes(src, path="fixture.py"):
    return sorted(f.code for f in lint_source(src, path).findings)


_CAPTURE = (
    "def capture(x, out):\n"
    "    g = torch.cuda.CUDAGraph()\n"
    "    with torch.cuda.graph(g):\n"
    "        body(x, out)\n"
    "    return g\n"
)


# ------------------------------------------------------------------ lint rules
def test_rl000_parse_error():
    assert codes("def f(:\n") == ["RL000"]


def test_rl101_host_call_in_graph_body():
    src = (
        "import time\n"
        "import numpy as np\n"
        "import torch\n"
        "def body(x, out):\n"
        "    print(x)\n"
        "    time.sleep(0.1)\n"
        "    out.copy_(torch.from_numpy(np.ones(3)))\n"
    ) + _CAPTURE
    assert codes(src) == ["RL101", "RL101", "RL101"]


def test_rl101_method_body_and_capture_block():
    src = (
        "import numpy as np\n"
        "import torch\n"
        "class Engine:\n"
        "    def _tick(self, buf):\n"
        "        print(buf)\n"
        "    def capture(self):\n"
        "        g = torch.cuda.CUDAGraph()\n"
        "        with torch.cuda.graph(g):\n"
        "            self._tick(self.buf * np.float32(2))\n"
        "        self._graph = g\n"
    )
    res = lint_source(src, "fixture.py")
    assert sorted(f.code for f in res.findings) == ["RL101", "RL101"]
    assert res.graph_bodies == ["fixture.py::Engine._tick"]


def test_rl101_host_call_outside_graph_ok():
    src = "import numpy as np\ndef f(x):\n    return np.sum(x)\n"
    assert codes(src) == []


@pytest.mark.parametrize("expr", [
    "x.item()", "x.tolist()", "x.cpu()", "x.numpy()", "float(x)",
    "int(x.sum())", "bool(x)", "torch.cuda.synchronize()",
])
def test_rl102_host_sync_in_graph_body(expr):
    src = (
        "import torch\n"
        "def body(x, out):\n"
        f"    y = {expr}\n"
        "    out.copy_(x)\n"
    ) + _CAPTURE
    assert codes(src) == ["RL102"]


def test_rl102_constants_and_static_values_ok():
    src = (
        "import torch\n"
        "def body(x, out):\n"
        "    n = int(x.shape[0]) + int(4) + float(len(x))\n"
        "    out.copy_(x * n)\n"
    ) + _CAPTURE
    assert codes(src) == []


def test_rl103_tensor_branch():
    src = (
        "import torch\n"
        "def body(x, out):\n"
        "    if x.sum() > 0:\n"
        "        out.copy_(x)\n"
        "    while x < 3:\n"
        "        x = x + 1\n"
        "    out.add_(x if x.any() else 1)\n"
    ) + _CAPTURE
    assert codes(src) == ["RL103", "RL103", "RL103"]


def test_rl103_static_shape_dtype_device_ok():
    src = (
        "import torch\n"
        "def body(x, out):\n"
        "    if x.shape[0] > 1 and x.dtype == torch.float32:\n"
        "        out.copy_(x)\n"
        "    if x.device.type == 'cuda' or x.dim() == 2 or x.numel():\n"
        "        out.add_(1)\n"
    ) + _CAPTURE
    assert codes(src) == []


def test_rl103_keyword_only_config_exempt():
    src = (
        "import torch\n"
        "def body(x, out, *, scale=None):\n"
        "    y = x if scale is None else x * scale\n"
        "    out.copy_(y)\n"
    ) + _CAPTURE
    assert codes(src) == []


_ENGINE = (
    "import torch\n"
    "class Engine:\n"
    "    def __init__(self):\n"
    "        self._ring = torch.zeros(4)\n"
    "        self._graph = None\n"
    "    def _tick(self, ring):\n"
    "        ring.add_(1)\n"
    "    def _capture(self):\n"
    "        graph = torch.cuda.CUDAGraph()\n"
    "        with torch.cuda.graph(graph):\n"
    "            self._tick(self._ring)\n"
    "        self._graph = graph\n"
)


def test_rl104_rebinding_a_captured_buffer():
    src = _ENGINE + (
        "    def reset(self):\n"
        "        self._ring = torch.zeros(8)\n"
    )
    res = lint_source(src, "fixture.py")
    assert [f.code for f in res.findings] == ["RL104"]
    assert "self._ring" in res.findings[0].message


def test_rl104_growth_site_that_drops_the_graph_ok():
    src = _ENGINE + (
        "    def _grow(self):\n"
        "        self._ring = torch.zeros(8)\n"
        "        self._graph = None\n"
    )
    assert codes(src) == []


def test_rl104_graph_cache_cleared_ok_and_attribute_read_in_body():
    src = (
        "import torch\n"
        "class Step:\n"
        "    def _body(self, x):\n"
        "        self._state.add_(x * self.scale)\n"
        "    def _build(self, x):\n"
        "        graph = torch.cuda.CUDAGraph()\n"
        "        with torch.cuda.graph(graph):\n"
        "            self._body(x)\n"
        "        return {'graph': graph}\n"
        "    def __call__(self, x, sig):\n"
        "        entry = self._entries[sig] = self._build(x)\n"
        "        return entry\n"
        "    def bind(self, state):\n"
        "        self._state = state\n"
        "        self._entries.clear()\n"
        "    def rescale(self, s):\n"
        "        self.scale = s\n"
    )
    res = lint_source(src, "fixture.py")
    assert [(f.code, "self.scale" in f.message) for f in res.findings] == [
        ("RL104", True)]


_DONATE_PRELUDE = (
    "class Eng:\n"
    "    def _step(self, state, x):\n"
    "        state.add_(x)\n"
    "        return state\n"
    "    _step.donate_argnums = (0,)\n"
)


def test_rl105_donated_reuse():
    src = _DONATE_PRELUDE + (
        "    def run(self, state, x):\n"
        "        new = self._step(state, x)\n"
        "        return new - state\n"
    )
    assert codes(src) == ["RL105"]


def test_rl105_host_read_after_donation():
    src = _DONATE_PRELUDE + (
        "    def snapshot(self, state, x):\n"
        "        out = self._step(state, x)\n"
        "        host = state.cpu()\n"
        "        return out, host\n"
    )
    res = lint_source(src, "fixture.py")
    assert [f.code for f in res.findings] == ["RL105"]
    assert "host read" in res.findings[0].message


def test_rl105_host_read_before_donation_ok():
    src = _DONATE_PRELUDE + (
        "    def snapshot(self, state, x):\n"
        "        host = state.cpu()\n"
        "        out = self._step(state, x)\n"
        "        return out, host\n"
    )
    assert codes(src) == []


def test_rl105_loop_rebind_and_in_place_call_ok():
    src = _DONATE_PRELUDE + (
        "    def run(self, state, xs):\n"
        "        for x in xs:\n"
        "            state = self._step(state, x)\n"
        "        self._step(state, xs[0])  # in place: state is the output\n"
        "        return state\n"
    )
    assert codes(src) == []


def test_rl105_static_step_donates_unless_told_not_to():
    body = (
        "def run(state, batch):\n"
        "    new, metrics = step(state, batch)\n"
        "    return new.params, state.params\n"
    )
    donating = "from repro_torch.train.loop import StaticStep\n" \
               "step = StaticStep(host, device)\n"
    keeping = "from repro_torch.train.loop import StaticStep\n" \
              "step = StaticStep(host, device, donate=False)\n"
    assert codes(donating + body) == ["RL105"]
    assert codes(keeping + body) == []


def test_rl106_float64():
    src = (
        "import torch\n"
        "def f(x):\n"
        "    return (x.to(torch.float64), x.double(),\n"
        '            torch.zeros(3, dtype="float64"), torch.double)\n'
    )
    assert codes(src) == ["RL106"] * 4


def test_rl106_host_numpy_f64_ok():
    src = "import numpy as np\ndef f(x):\n    return np.float64(x)\n"
    assert codes(src) == []


def test_rl201_unused_import():
    src = "import os\nimport sys\nprint(sys.argv)\n"
    assert codes(src) == ["RL201"]


def test_rl201_init_py_and_all_exempt():
    assert codes("import os\n", path="pkg/__init__.py") == []
    assert codes("from os import path\n__all__ = ['path']\n") == []


def test_rl202_unreachable():
    src = "def f():\n    return 1\n    x = 2\n"
    assert codes(src) == ["RL202"]


# ------------------------------------------------------------------ suppression
def test_line_suppression_moves_to_suppressed():
    src = (
        "import torch\n"
        "def body(x, out):\n"
        "    print(x)  # repro-lint: disable=RL101 -- debugging aid\n"
        "    out.copy_(x)\n"
    ) + _CAPTURE
    res = lint_source(src, "fixture.py")
    assert [f.code for f in res.findings] == []
    assert [f.code for f in res.suppressed] == ["RL101"]


def test_file_level_suppression():
    src = (
        "# repro-lint: disable-file=RL201 -- fixture\n"
        "import os\n"
        "import sys\n"
    )
    res = lint_source(src, "fixture.py")
    assert [f.code for f in res.findings] == []
    assert sorted(f.code for f in res.suppressed) == ["RL201", "RL201"]


def test_unrelated_suppression_does_not_hide():
    src = "import os  # repro-lint: disable=RL106 -- wrong code\n"
    assert codes(src) == ["RL201"]


def test_rules_table_covers_emitted_codes():
    assert set(RULES) == {"RL000", "RL101", "RL102", "RL103", "RL104",
                          "RL105", "RL106", "RL201", "RL202"}
    assert "RL107" not in RULES  # pl.BlockSpec has no counterpart


# --------------------------------------------- the real graph bodies' hazards
ENGINE = ROOT / "src" / "repro_torch" / "serving" / "snn_engine.py"
LOOP = ROOT / "src" / "repro_torch" / "train" / "loop.py"
LM_ENGINE = ROOT / "src" / "repro_torch" / "serving" / "engine.py"


def test_the_real_graph_bodies_are_found():
    res = lint_paths([ENGINE, LOOP, LM_ENGINE], rel_to=ROOT)
    assert res.findings == []
    assert sorted(res.graph_bodies) == [
        "src/repro_torch/serving/engine.py::ServeEngine._decode_body",
        "src/repro_torch/serving/engine.py::ServeEngine._prefill_body",
        "src/repro_torch/serving/snn_engine.py::SNNStreamEngine._chunk",
        "src/repro_torch/serving/snn_engine.py::SNNStreamEngine._stage",
        "src/repro_torch/train/loop.py::StaticStep._body",
    ]


_HAZARDS = {
    "item_in_chunk": (
        ENGINE, "        take = torch.clamp(total - done, 0, Tc)\n",
        "        n = take.sum().item()\n", "RL102"),
    "branch_in_stage": (
        ENGINE, "        T = train.shape[0]\n",
        "        if train.any():\n            T = T + 0\n", "RL103"),
    "host_clock_in_stage": (
        ENGINE, "        T = train.shape[0]\n",
        "        t = time.perf_counter()\n", "RL101"),
    "float_in_static_step_body": (
        LOOP, "        state = TrainState(*self._state, 0)\n",
        "        lr = float(inputs['lr'])\n", "RL102"),
    "ring_rebound_outside_grow_ring": (
        ENGINE, "    def steady_state_recompiles(self) -> int:\n",
        "    def _reset_ring(self) -> None:\n"
        "        self._ring = self._alloc_ring(self._ring_steps)\n\n", "RL104"),
    "item_in_lm_decode": (
        LM_ENGINE, "        logits, _ = self.model.decode_step(self.params, token, pos, cache)\n",
        "        n = pos.max().item()\n", "RL102"),
    "branch_in_lm_prefill": (
        LM_ENGINE, "        logits, new = self.model.prefill(self.params, batch, self.cache_len)\n",
        "        if logits.isnan().any():\n            logits = logits + 0\n",
        "RL103"),
    "lm_params_rebound_without_dropping_graphs": (
        LM_ENGINE, "    def _graph_pool(self):\n",
        "    def _swap(self, params) -> None:\n"
        "        self.params = params\n\n", "RL104"),
    "state_rebound_without_dropping_graphs": (
        LOOP, "    def _export(self, step: int) -> TrainState:\n",
        "    def _swap(self, state) -> None:\n"
        "        self._state = state\n\n", "RL104"),
}


@pytest.mark.parametrize("hazard", sorted(_HAZARDS))
def test_a_hazard_planted_in_a_real_graph_body_is_caught(hazard):
    path, anchor, planted, code = _HAZARDS[hazard]
    src = path.read_text()
    assert src.count(anchor) == 1, anchor
    at = src.index(anchor)
    if planted.startswith("    def "):
        src = src[:at] + planted + src[at:]  # a new method before the anchor
    else:
        src = src[:at + len(anchor)] + planted + src[at + len(anchor):]
    res = lint_source(src, str(path.relative_to(ROOT)))
    assert [f.code for f in res.findings] == [code], [
        f.render() for f in res.findings]


# ------------------------------------------------------------------ kernel budgets
def test_kernel_budgets_all_kernels_fit(tmp_path):
    plans, findings = check_kernel_budgets(build_dir=tmp_path)
    assert [f.render() for f in findings] == []
    assert {p.kernel for p in plans} == set(KERNEL_PLANNERS)
    assert {n.split("[")[0] for n in KERNEL_PLANNERS} == {
        "snn_chunk", "aer_spike_matmul_batched", "aer_spike_matmul",
        "lif_fused", "spike_matmul", "q115_matmul", "decode_attention",
        "mla_decode"}
    for p in plans:
        assert p.errors == [], p.kernel
        assert 0 <= p.smem_bytes <= DEFAULT_SMEM_BUDGET
        assert 32 <= p.threads <= 1024 and p.threads % 32 == 0
        assert 1 <= p.cluster <= 8 and p.grid and p.ctas > 0
        assert all(c["grid"] >= c["operand"] for c in p.covers.values())
        # no ptxas report on the CPU: left empty, and the plan says so
        assert p.registers is None and p.spill_bytes is None
        assert "not known" in p.ptxas


def test_kernel_budget_overflow_flagged(tmp_path):
    plans, findings = check_kernel_budgets(smem_budget=1024, build_dir=tmp_path)
    assert findings and all(f.code == "RB301" for f in findings)
    assert len(findings) == sum(p.smem_bytes > 1024 for p in plans)
    assert {f.message.split(":")[0] for f in findings} == {
        p.kernel for p in plans if p.smem_bytes > 1024}


def test_snn_chunk_plan_shape(tmp_path):
    (serve, evaluate), findings = check_kernel_budgets(
        kernels=["snn_chunk", "snn_chunk[evaluate]"], build_dir=tmp_path)
    assert not findings
    assert serve.cluster == 8 and serve.grid == (8 * 8,)
    assert evaluate.grid == (32 * 8,)
    assert serve.geometry["steps"] == 5 and evaluate.geometry["steps"] == 25
    assert 0 < serve.smem_bytes < evaluate.smem_bytes
    assert set(serve.covers) == {"layer0_columns", "layer1_columns", "slots",
                                 "steps"}


def test_launch_constants_are_read_from_the_sources():
    from repro_torch.kernels import aer_matmul, lif_fused, q115_matmul, snn_chunk

    smm = kernel_budget.cu_defines("spike_matmul")
    assert smm["SMM_SMEM"] == (
        smm["SMM_S_STAGES"] * smm["SMM_BM"] * smm["SMM_S_ROW"]
        + smm["SMM_W_STAGES"] * smm["SMM_BK"] * smm["SMM_W_ROW"]
        + 2 * smm["SMM_BN"] * smm["SMM_T_WORDS"] * 4) == 87040
    assert kernel_budget.cu_defines("lif_fused")["LIF_THREADS"] == lif_fused.THREADS
    assert kernel_budget.cu_defines("snn_chunk")["SNN_CLUSTER"] == snn_chunk.CLUSTER
    assert (kernel_budget.cu_defines("aer_matmul")["AER_SMEM_MAX"]
            == aer_matmul.SMEM_LIMIT)
    q = kernel_budget.cu_defines("q115_matmul")
    assert q["Q_CLUSTER_MAX"] == q115_matmul.CLUSTER_MAX
    assert q["Q_BN"] == q115_matmul.TILE_N and q["Q_BK"] == q115_matmul.TILE_K
    assert kernel_budget.q115_smem(8) == 89088
    assert kernel_budget.q115_smem(4) == 73216


PTXAS_SAMPLE = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z16snn_chunk_kernelILb1EEv10SnnParams' for 'sm_90a'
ptxas info    : Function properties for _Z16snn_chunk_kernelILb1EEv10SnnParams
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers, 8 bytes cumulative stack size, 400 bytes cmem[0]
ptxas info    : Function properties for _Z9helperPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_Z17aer_merged_kernelILb1EEvPKiPKfS3_Pfiiiii' for 'sm_90a'
ptxas info    : Function properties for _Z17aer_merged_kernelILb1EEvPKiPKfS3_Pfiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 62 registers, used 16 barriers, 48 bytes smem, 400 bytes cmem[0]
"""


def test_parse_ptxas_sample():
    got = kernel_budget.parse_ptxas(PTXAS_SAMPLE)
    assert list(got) == ["_Z16snn_chunk_kernelILb1EEv10SnnParams",
                         "_Z17aer_merged_kernelILb1EEvPKiPKfS3_Pfiiiii"]
    snn = got["_Z16snn_chunk_kernelILb1EEv10SnnParams"]
    assert (snn["registers"], snn["spill_stores"], snn["spill_loads"],
            snn["stack"], snn["smem"]) == (128, 4, 4, 8, 0)
    aer = got["_Z17aer_merged_kernelILb1EEvPKiPKfS3_Pfiiiii"]
    assert (aer["registers"], aer["spill_stores"], aer["smem"]) == (62, 0, 48)


def _reports(tmp_path, text_of):
    for name in _build.SIGNATURES:
        (tmp_path / _build.ptxas_log_path(name).name).write_text(text_of(name))


def test_ptxas_reports_fill_registers_and_judge_spills(tmp_path):
    def entry(kernel, regs, spill, smem=0):
        return (f"ptxas info    : Compiling entry function '_Z3{kernel}v' for "
                f"'sm_90a'\nptxas info    : Function properties for _Z3{kernel}v\n"
                f"    0 bytes stack frame, {spill} bytes spill stores, {spill} "
                f"bytes spill loads\nptxas info    : Used {regs} registers, "
                f"used 1 barriers, {smem} bytes smem\n")

    clean = {
        "snn_chunk": entry("snn_chunk_kernel", 128, 4),  # within its allowance
        "aer_matmul": "".join(entry(f"aer_{v}_kernel", 62, 0, 48)
                              for v in ("merged", "narrow", "rows", "split")),
        "lif_fused": entry("lif_fused_kernel", 90, 0) + entry(
            "lif_empty_kernel", 4, 0),
        "spike_matmul": entry("spike_matmul_kernel", 124, 0),
        "q115_matmul": entry("q115_matmul_kernel", 110, 0) + entry(
            "q115_rate_kernel", 72, 0),
        # the phase markers' source: empty kernels, no budget of their own
        "phase_marker": entry("phase_marker_update_end", 4, 0),
        "decode_attention": entry("decode_attention_kernelILi8ELi1EE", 40, 0,
                                  16),
        "mla_decode": "".join(entry(f"mla_decode_kernelILi{g}EE", regs, 0)
                              for g, regs in ((3, 198), (2, 194), (1, 183))),
    }
    _reports(tmp_path, clean.get)
    plans, findings = check_kernel_budgets(build_dir=tmp_path)
    assert [f.render() for f in findings] == []
    by = {p.kernel: p for p in plans}
    assert by["snn_chunk"].registers == 128 and by["snn_chunk"].spill_bytes == 8
    assert by["aer_spike_matmul_batched"].static_smem_bytes == 48
    assert by["lif_fused"].registers == 90 and by["lif_fused"].entries == 1
    assert by["q115_matmul"].registers == 110
    assert by["decode_attention"].registers == 40
    # the cell's instantiation alone: 198 registers x 256 threads, no spill
    assert by["mla_decode"].registers == 198 and by["mla_decode"].entries == 1
    assert by["mla_decode"].spill_bytes == by["mla_decode"].static_smem_bytes == 0

    spilling = dict(clean, spike_matmul=entry("spike_matmul_kernel", 124, 16),
                    snn_chunk=entry("snn_chunk_kernel", 255, 8))
    _reports(tmp_path, spilling.get)
    _, findings = check_kernel_budgets(build_dir=tmp_path)
    got = sorted((f.code, f.message.split(":")[0]) for f in findings)
    assert got == sorted([
        ("RB304", "spike_matmul"),  # 32 B spilled, none allowed
        ("RB304", "snn_chunk"), ("RB304", "snn_chunk[evaluate]"),  # 16 > 8
        # 255 registers x 320 (448) threads > an SM's 65,536
        ("RB302", "snn_chunk"), ("RB302", "snn_chunk[evaluate]"),
    ])
    missing = dict(clean, lif_fused="ptxas info    : 0 bytes gmem\n")
    _reports(tmp_path, missing.get)
    _, findings = check_kernel_budgets(kernels=["lif_fused"], build_dir=tmp_path)
    assert [f.code for f in findings] == ["RB302"]  # no entry to read


# ------------------------------------------------------------------ repo-wide
def test_repo_tree_is_lint_clean():
    from repro_torch.analysis.__main__ import REPO_ROOT

    res = lint_paths([REPO_ROOT / "src" / "repro_torch"], rel_to=REPO_ROOT)
    assert [f.render() for f in res.findings] == []


def test_every_suppression_in_the_port_carries_a_reason():
    import re

    pat = re.compile(r"#\s*repro-lint:\s*disable(?:-file)?=([A-Z0-9,]+)(.*)$")
    for path in (ROOT / "src" / "repro_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            m = pat.search(line)
            if m:
                assert re.match(r"\s*--\s*\S", m.group(2)), (path, line)


def test_cli_exits_zero_and_writes_json(tmp_path):
    from repro_torch.analysis.__main__ import main

    out = tmp_path / "report.json"
    rc = main(["--json", str(out), "--no-kernels", "--no-aer"])
    assert rc == 0
    doc = json.loads(out.read_text())
    assert doc["schema"] == "repro-torch-analysis/v1"
    assert doc["counts"]["findings"] == 0 and doc["counts"]["new"] == 0
    assert len(doc["graph_bodies"]) == 5


def test_cli_baseline_accepts_known_findings(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main

    bad = tmp_path / "bad.py"
    bad.write_text("import os\n")
    base = tmp_path / "base.json"
    args = [str(bad), "--no-kernels", "--no-aer", "--baseline", str(base)]
    assert main(args) == 1
    assert main(args + ["--update-baseline"]) == 0
    assert json.loads(base.read_text())["schema"] == (
        "repro-torch-lint-baseline/v1")
    assert main(args) == 0
    assert "0 new finding(s), 1 baselined" in capsys.readouterr().out


def test_shipped_baseline_is_empty_with_its_own_schema():
    doc = json.loads((ROOT / "analysis_baseline_torch.json").read_text())
    assert doc == {"schema": "repro-torch-lint-baseline/v1", "findings": []}


def test_cli_full_run_in_a_process_that_loads_no_jax(tmp_path):
    out = tmp_path / "report.json"
    code = (
        "import sys\n"
        "from repro_torch.analysis.__main__ import main\n"
        f"rc = main(['--json', {str(out)!r}])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "repro-lint: 0 new finding(s)" in proc.stdout
    doc = json.loads(out.read_text())
    assert doc["counts"]["findings"] == 0
    assert {p["kernel"] for p in doc["kernels"]} == set(KERNEL_PLANNERS)
    assert all(p["errors"] == [] for p in doc["kernels"])
    assert doc["aer_bounds"]["ok"]
    assert "SNNStreamEngine._stage" in " ".join(doc["graph_bodies"])
