"""Static launch budgets of the port's Hopper kernels.

The counterpart of the reference's ``repro.analysis.kernel_budget``.
Rather than re-deriving each kernel's launch by hand (which would rot the
moment a kernel changes), this module asks each wrapper's own ``plan``
for the geometry it would launch at the main paths' shapes, and reads the
launchers' constants (threads, shared-memory layout) from the ``#define``
lines of their ``csrc/*.cu`` sources.  Where the build left ``ptxas``'s
report beside a library (``kernels._build.ptxas_log_path``: the card's
runs), it adds each kernel's registers, spills and static shared memory.

Per kernel and geometry it checks, with codes of the reference's family:

- RB301: dynamic plus static shared memory of a CTA over the 232,448
  bytes (227 KB) a CTA of an H100 may take;
- RB302: a launch the card refuses: over 1,024 threads a CTA, a cluster
  over the portable 8, a grid dimension over its limit, or registers x
  threads over an SM's 65,536 registers;
- RB303: a grid that does not cover its operand (rows, columns, steps or
  events left without a CTA);
- RB304: spilled registers (``ptxas``'s spill stores and loads) over the
  kernel's allowance, which is 0 unless ``SPILL_ALLOWANCE`` records a
  known spill with its reason.

The reference's VMEM and scalar-prefetch SMEM budgets have no Hopper
counterpart: the port's kernels stage in shared memory, budgeted here as
``DEFAULT_SMEM_BUDGET``.  Without a ``ptxas`` report (the CPU, where no
kernel is built) registers and spills are ``None`` and the plan says so.
"""

from __future__ import annotations

import ast
import dataclasses
import operator
import re
from pathlib import Path
from typing import Callable, Sequence

from repro_torch.analysis.torchlint import Finding

DEFAULT_SMEM_BUDGET = 232_448  # shared memory a CTA may take on an H100
MAX_THREADS = 1024  # threads a CTA
MAX_CLUSTER = 8  # the portable cluster size
REGS_PER_SM = 65_536
GRID_X_MAX, GRID_YZ_MAX = 2**31 - 1, 65_535
#: known spills (bytes of spill stores plus loads) a kernel is allowed,
#: each with its reason; any other spill is a finding
SPILL_ALLOWANCE: dict[str, tuple[int, str]] = {
    "snn_chunk": (8, "one 4-byte word stored and loaded once under "
                     "__launch_bounds__(512)'s 128-register cap"),
}

_CSRC = Path(__file__).resolve().parents[1] / "kernels" / "csrc"

# the collision network at the main paths' geometries (ROADMAP: serving
# 8 slots x Tc = 5, evaluate B = 32 x Tc = 25; training B = 32; the
# hardware path B = 8, T = 25 and its (200, 4096) x (4096, 512) products)
_WIDTHS = (4096, 512, 2)
_SLOTS, _TC, _T = 8, 5, 25
_TRAIN_B, _HW_B = 32, 8


@dataclasses.dataclass
class KernelPlan:
    kernel: str
    source: str  # the kernel's csrc file, relative to the repo
    entry: str  # substring of its entry functions' (mangled) names
    geometry: dict  # the shape it was planned at
    grid: tuple[int, ...]
    threads: int
    cluster: int
    smem_bytes: int  # dynamic shared memory a CTA
    covers: dict  # what the grid covers of each operand dimension
    errors: list[str]
    static_smem_bytes: int | None = None  # from ptxas
    registers: int | None = None  # from ptxas, the most of any entry
    spill_bytes: int | None = None  # spill stores + loads, from ptxas
    entries: int = 0  # entry functions ptxas reported for it
    ptxas: str | None = None  # the report read, or why there is none

    @property
    def ctas(self) -> int:
        n = 1
        for g in self.grid:
            n *= g
        return n

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["grid"] = list(self.grid)
        d["ctas"] = self.ctas
        return d


# ---------------------------------------------------------------------------
# the launchers' constants and ptxas's report
# ---------------------------------------------------------------------------

_DEFINE = re.compile(r"^\s*#define\s+([A-Z][A-Z0-9_]*)\s+(.*?)\s*(?://.*)?$")
_OPS = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
        ast.FloorDiv: operator.floordiv, ast.Div: operator.floordiv}


def cu_defines(name: str, csrc: Path = _CSRC) -> dict[str, int]:
    """The integer ``#define``s of ``csrc/<name>.cu``, macro expressions
    of other defines (``SMM_SMEM``) evaluated; continuation lines are
    joined.  Defines that are not integer arithmetic are left out."""
    text = (csrc / f"{name}.cu").read_text().replace("\\\n", " ")
    raw = {}
    for line in text.splitlines():
        m = _DEFINE.match(line)
        if m and m.group(2):
            raw[m.group(1)] = m.group(2)
    out: dict[str, int] = {}

    def value(key, seen=()):
        if key in out:
            return out[key]
        if key in seen or key not in raw:
            raise KeyError(key)
        node = ast.parse(raw[key], mode="eval").body

        def ev(n):
            if isinstance(n, ast.Constant) and isinstance(n.value, int):
                return n.value
            if isinstance(n, ast.Name):
                return value(n.id, seen + (key,))
            if isinstance(n, ast.BinOp) and type(n.op) in _OPS:
                return _OPS[type(n.op)](ev(n.left), ev(n.right))
            raise KeyError(key)

        out[key] = int(ev(node))
        return out[key]

    for key in raw:
        try:
            value(key)
        except (KeyError, SyntaxError):
            pass
    return out


_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PROPS = re.compile(r"Function properties for (\S+)")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers")
_SMEM = re.compile(r"(\d+) bytes smem")


def parse_ptxas(log: str) -> dict[str, dict]:
    """Entry function -> {registers, spill_stores, spill_loads, stack,
    smem} from ``nvcc -Xptxas=-v`` output.  ``Function properties`` lines
    of device functions that are not entries are left out."""
    entries: dict[str, dict] = {}
    current = props = None
    for line in log.splitlines():
        m = _ENTRY.search(line)
        if m:
            current = m.group(1)
            entries[current] = {"registers": None, "spill_stores": 0,
                                "spill_loads": 0, "stack": 0, "smem": 0}
            continue
        m = _PROPS.search(line)
        if m:
            props = m.group(1)
            continue
        m = _SPILL.search(line)
        if m and props in entries:
            e = entries[props]
            e["stack"], e["spill_stores"], e["spill_loads"] = (
                int(m.group(1)), int(m.group(2)), int(m.group(3)))
            continue
        m = _USED.search(line)
        if m and current in entries:
            entries[current]["registers"] = int(m.group(1))
            s = _SMEM.search(line)
            entries[current]["smem"] = int(s.group(1)) if s else 0
    return entries


def _read_ptxas(plan: KernelPlan, source: str, build_dir: Path | None) -> None:
    """Fill ``plan``'s registers, spills and static shared memory from the
    report beside ``source``'s library, the worst of its entries."""
    from repro_torch.kernels import _build

    path = _build.ptxas_log_path(source)
    if build_dir is not None:
        path = Path(build_dir) / path.name
    if not path.exists():
        plan.ptxas = (f"no ptxas report at {path.name}: registers and spills "
                      "not known (kernels are built on the card)")
        return
    entries = [e for name, e in parse_ptxas(path.read_text()).items()
               if plan.entry in name]
    plan.ptxas = path.name
    plan.entries = len(entries)
    if not entries:
        plan.errors.append(f"ptxas report {path.name} names no entry "
                           f"function `{plan.entry}`")
        return
    plan.registers = max(e["registers"] or 0 for e in entries)
    plan.spill_bytes = max(e["spill_stores"] + e["spill_loads"] for e in entries)
    plan.static_smem_bytes = max(e["smem"] for e in entries)


def _cover(plan_errors, covers, name, got, need):
    covers[name] = {"grid": int(got), "operand": int(need)}
    if got < need:
        plan_errors.append(f"grid covers {got} of {need} along {name}")


# ---------------------------------------------------------------------------
# per-kernel planners: each wrapper's own plan at the main paths' shapes
# ---------------------------------------------------------------------------


def _plan_snn_chunk(batch: int, steps: int) -> KernelPlan:
    from repro_torch.kernels import snn_chunk as mod

    p = mod.plan(_WIDTHS, steps, batch)
    errors: list[str] = []
    covers: dict = {}
    for i, (cols, n) in enumerate(zip(p.cols, _WIDTHS[1:])):
        _cover(errors, covers, f"layer{i}_columns", cols * mod.CLUSTER, n)
    _cover(errors, covers, "slots", p.ctas // mod.CLUSTER, batch)
    blocks = -(-steps // p.step_block)
    _cover(errors, covers, "steps", blocks * p.step_block, steps)
    d = cu_defines("snn_chunk")
    if d.get("SNN_CLUSTER") != mod.CLUSTER:
        errors.append(f"cluster {mod.CLUSTER} != the source's SNN_CLUSTER "
                      f"{d.get('SNN_CLUSTER')}")
    if p.threads > d.get("SNN_MAX_THREADS", MAX_THREADS):
        errors.append(f"{p.threads} threads over __launch_bounds__ "
                      f"{d.get('SNN_MAX_THREADS')}")
    return KernelPlan("snn_chunk", "snn_chunk", "snn_chunk_kernel",
                      {"widths": list(_WIDTHS), "batch": batch, "steps": steps,
                       "step_block": p.step_block},
                      (p.ctas,), p.threads, mod.CLUSTER, p.smem, covers, errors)


def _plan_aer(name: str, B: int, E: int, K: int, N: int,
              int16: bool) -> KernelPlan:
    from repro_torch.kernels import aer_matmul as mod

    p = mod.plan(B, E, K, N, int16)
    errors: list[str] = []
    covers: dict = {}
    rows = -(-B // p.streams)
    _cover(errors, covers, "streams", rows * p.streams, B)
    _cover(errors, covers, "columns", p.slices * p.cols, N)
    _cover(errors, covers, "events", p.splits * p.e_chunk, E)
    d = cu_defines("aer_matmul")
    if p.smem > d.get("AER_SMEM_MAX", DEFAULT_SMEM_BUDGET):
        errors.append(f"shared memory {p.smem} over AER_SMEM_MAX "
                      f"{d.get('AER_SMEM_MAX')}")
    return KernelPlan(name, "aer_matmul", f"aer_{p.variant}_kernel",
                      {"B": B, "E": E, "K": K, "N": N, "int16": int16,
                       "variant": p.variant},
                      (rows, p.slices, p.splits), p.threads, 1, p.smem, covers,
                      errors)


def _plan_lif_fused() -> KernelPlan:
    T, B, N = _T, _HW_B, _WIDTHS[1]
    threads = cu_defines("lif_fused")["LIF_THREADS"]
    blocks = -(-B * N // threads)
    errors: list[str] = []
    covers: dict = {}
    _cover(errors, covers, "neurons", blocks * threads, B * N)
    return KernelPlan("lif_fused", "lif_fused", "lif_fused_kernel",
                      {"T": T, "B": B, "N": N}, (blocks,), threads, 1, 0,
                      covers, errors)


def _plan_spike_matmul() -> KernelPlan:
    from repro_torch.kernels import spike_matmul as mod

    M, K, N = _HW_B * _T, _WIDTHS[0], _WIDTHS[1]
    p = mod.plan(M, K, N)
    d = cu_defines("spike_matmul")
    errors: list[str] = []
    covers: dict = {}
    _cover(errors, covers, "rows", p.m_tiles * d["SMM_BM"], M)
    _cover(errors, covers, "columns", p.n_tiles * d["SMM_BN"], N)
    _cover(errors, covers, "k", p.split * p.slabs_per_split * d["SMM_BK"], K)
    return KernelPlan("spike_matmul", "spike_matmul", "spike_matmul_kernel",
                      {"M": M, "K": K, "N": N, "split": p.split},
                      (p.n_tiles, p.m_tiles, p.split), d["SMM_THREADS"], 1,
                      d["SMM_SMEM"], covers, errors)


def q115_smem(warps: int) -> int:
    """``q_smem`` of csrc/q115_matmul.cu from its defines: the raw slab
    ring, then the two int32 slabs the cluster reduction reuses."""
    d = cu_defines("q115_matmul")
    bm = d["Q_TM"] * warps
    return (d["Q_STAGES"] * (bm * d["Q_RX_PITCH"] + d["Q_RW_TILE"]) * 2
            + 2 * (d["Q_BK"] * bm + d["Q_CW_TILE"]) * 4)


def _plan_q115(name: str, M: int, K: int, N: int, saturate: bool) -> KernelPlan:
    from repro_torch.kernels import q115_matmul as mod

    p = mod.plan(M, K, N, saturate)
    d = cu_defines("q115_matmul")
    errors: list[str] = []
    covers: dict = {}
    _cover(errors, covers, "rows", p.m_tiles * d["Q_TM"] * p.warps, M)
    _cover(errors, covers, "columns", p.n_tiles * d["Q_BN"], N)
    _cover(errors, covers, "k", p.split * p.k_per_split, K)
    return KernelPlan(name, "q115_matmul", "q115_matmul_kernel",
                      {"M": M, "K": K, "N": N, "saturate": saturate,
                       "warps": p.warps, "split": p.split},
                      (p.n_tiles, p.m_tiles, p.split), 32 * p.warps, p.cluster,
                      q115_smem(p.warps), covers, errors)


# the LM serving cell's decode step: B 32, a cache of 1,280 rows, 32 kv
# heads of 64 (stablelm-1.6b), one query a kv head
_DECODE = dict(B=32, S=1280, Kv=32, G=1, D=64)


def _plan_decode_attention() -> KernelPlan:
    from repro_torch.kernels import decode_attention as mod

    B, S, Kv, G, D = (_DECODE[k] for k in ("B", "S", "Kv", "G", "D"))
    p = mod.plan(B, S, Kv, G, D)
    d = cu_defines("decode_attention")
    errors: list[str] = []
    covers: dict = {}
    _cover(errors, covers, "kv_heads", p.grid[0], Kv)
    _cover(errors, covers, "rows", p.grid[1], B)
    if d.get("DA_THREADS") != mod.THREADS:
        errors.append(f"{mod.THREADS} threads != the source's DA_THREADS "
                      f"{d.get('DA_THREADS')}")
    if d.get("DA_SCORES_MAX") != mod.SCORES_MAX:
        errors.append(f"SCORES_MAX {mod.SCORES_MAX} != the source's "
                      f"DA_SCORES_MAX {d.get('DA_SCORES_MAX')}")
    if p.smem > d.get("DA_SMEM_MAX", DEFAULT_SMEM_BUDGET):
        errors.append(f"shared memory {p.smem} over DA_SMEM_MAX "
                      f"{d.get('DA_SMEM_MAX')}")
    # the instantiation the cell's shape launches: 8 lanes a row (D <= 64),
    # one query group
    return KernelPlan("decode_attention", "decode_attention",
                      "decode_attention_kernelILi8ELi1EE", dict(_DECODE),
                      p.grid,
                      p.threads, 1, p.smem, covers, errors)


# the DeepSeek serving cell's decode step: B 128, a latent cache of 1,536
# rows, 16 heads of rank 512 and rope 64 (deepseek-v2-lite)
_MLA = dict(B=128, S=1536, H=16)


def _plan_mla_decode() -> KernelPlan:
    from repro_torch.kernels import mla_decode as mod

    B, S, H = (_MLA[k] for k in ("B", "S", "H"))
    p = mod.plan(B, S, H)
    d = cu_defines("mla_decode")
    errors: list[str] = []
    covers: dict = {}
    _cover(errors, covers, "cache_rows", p.grid[0] * p.rows, S)
    _cover(errors, covers, "heads", p.grid[1] * mod.HEADS, H)
    _cover(errors, covers, "rows", p.grid[2], B)
    for name, want in (("MLA_THREADS", mod.THREADS),
                       ("MLA_CLUSTER", mod.CLUSTER), ("MLA_HEADS", mod.HEADS),
                       ("MLA_RANK", mod.RANK), ("MLA_ROPE", mod.ROPE),
                       ("MLA_GROUP", mod.GROUP),
                       ("MLA_GROUPS_MAX", mod.GROUPS_MAX)):
        if d.get(name) != want:
            errors.append(f"{want} != the source's {name} {d.get(name)}")
    if p.smem > d.get("MLA_SMEM_MAX", DEFAULT_SMEM_BUDGET):
        errors.append(f"shared memory {p.smem} over MLA_SMEM_MAX "
                      f"{d.get('MLA_SMEM_MAX')}")
    # the instantiation the cell's shape launches: 3 groups of 64 rows
    return KernelPlan("mla_decode", "mla_decode", "mla_decode_kernelILi3EE",
                      dict(_MLA), p.grid, p.threads, p.cluster, p.smem,
                      covers, errors)


K0, N0, N1 = _WIDTHS
KERNEL_PLANNERS: dict[str, Callable[[], KernelPlan]] = {
    "snn_chunk": lambda: _plan_snn_chunk(_SLOTS, _TC),
    "snn_chunk[evaluate]": lambda: _plan_snn_chunk(_TRAIN_B, _T),
    "aer_spike_matmul_batched": lambda: _plan_aer(
        "aer_spike_matmul_batched", _TRAIN_B, K0, K0, N0, False),
    "aer_spike_matmul_batched[layer1]": lambda: _plan_aer(
        "aer_spike_matmul_batched[layer1]", _TRAIN_B, N0, N0, N1, False),
    "aer_spike_matmul": lambda: _plan_aer(
        "aer_spike_matmul", 1, K0, K0, N0, True),
    "lif_fused": _plan_lif_fused,
    "spike_matmul": _plan_spike_matmul,
    "q115_matmul": lambda: _plan_q115("q115_matmul", _HW_B * _T, K0, N0, True),
    "q115_matmul[raw]": lambda: _plan_q115(
        "q115_matmul[raw]", _HW_B * _T, K0, N0, False),
    "q115_matmul[128x512x128]": lambda: _plan_q115(
        "q115_matmul[128x512x128]", 128, 512, 128, True),
    "decode_attention": _plan_decode_attention,
    "mla_decode": _plan_mla_decode,
}


def _base(name: str) -> str:
    return name.split("[", 1)[0]


def check_kernel_budgets(
    smem_budget: int = DEFAULT_SMEM_BUDGET,
    kernels: Sequence[str] | None = None,
    build_dir: Path | str | None = None,
) -> tuple[list[KernelPlan], list[Finding]]:
    """Plan and check every kernel (or those named); returns (plans,
    findings).  ``build_dir`` overrides where ``ptxas`` reports are read
    (default: the build directory of ``kernels._build``)."""
    plans: list[KernelPlan] = []
    findings: list[Finding] = []
    for name in kernels or KERNEL_PLANNERS:
        path = f"src/repro_torch/kernels/{_base(name)}.py"
        if _base(name).startswith("aer_"):
            path = "src/repro_torch/kernels/aer_matmul.py"
        try:
            plan = KERNEL_PLANNERS[name]()
        except Exception as e:  # a plan that raises is itself a finding
            findings.append(Finding(path, 1, 0, "RB302",
                                    f"{name}: plan failed: {type(e).__name__}: {e}"))
            continue
        plan.kernel = name
        _read_ptxas(plan, plan.source, None if build_dir is None else Path(build_dir))
        plans.append(plan)
        findings.extend(_judge(plan, path, smem_budget))
    return plans, findings


def _judge(plan: KernelPlan, path: str, smem_budget: int) -> list[Finding]:
    name, out = plan.kernel, []
    smem = plan.smem_bytes + (plan.static_smem_bytes or 0)
    if smem > smem_budget:
        out.append(Finding(path, 1, 0, "RB301",
                           f"{name}: {smem} B of shared memory a CTA exceeds "
                           f"the budget of {smem_budget} B"))
    limits = []
    if plan.threads > MAX_THREADS:
        limits.append(f"{plan.threads} threads a CTA (max {MAX_THREADS})")
    if plan.cluster > MAX_CLUSTER:
        limits.append(f"a cluster of {plan.cluster} (max {MAX_CLUSTER})")
    if plan.grid and plan.grid[0] > GRID_X_MAX or any(
            g > GRID_YZ_MAX for g in plan.grid[1:]):
        limits.append(f"grid {plan.grid} over the grid limits")
    if plan.registers is not None and plan.registers * plan.threads > REGS_PER_SM:
        limits.append(f"{plan.registers} registers x {plan.threads} threads "
                      f"over an SM's {REGS_PER_SM}")
    for lim in limits:
        out.append(Finding(path, 1, 0, "RB302", f"{name}: {lim}"))
    allowed = SPILL_ALLOWANCE.get(_base(name), (0, ""))[0]
    if plan.spill_bytes is not None and plan.spill_bytes > allowed:
        out.append(Finding(path, 1, 0, "RB304",
                           f"{name}: {plan.spill_bytes} B of register spills "
                           f"(allowed {allowed})"))
    for err in plan.errors:
        code = "RB303" if err.startswith("grid covers") else "RB302"
        out.append(Finding(path, 1, 0, code, f"{name}: {err}"))
    return out


def render(plan: KernelPlan) -> str:
    """One line of the budget report."""
    regs = ("registers, spills: not known (no ptxas report)"
            if plan.registers is None else
            f"{plan.registers} registers, {plan.spill_bytes} B spilled, "
            f"{plan.static_smem_bytes} B static shared ({plan.entries} entries)")
    return (f"kernel {plan.kernel}: grid {plan.grid} = {plan.ctas} CTAs x "
            f"{plan.threads} threads, cluster {plan.cluster}, shared "
            f"{plan.smem_bytes} B a CTA | {regs}")
