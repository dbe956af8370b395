"""``python -m repro_torch.analysis`` — run the port's full repro-lint pass.

Runs, in order:

1. the AST lint over ``src/repro_torch`` (or the paths given), which
   also lists the CUDA graph bodies it found,
2. the Hopper kernel launch budgets (shared memory, threads, cluster,
   grid coverage; registers and spills where ``ptxas`` reports exist),
3. the AER address-width bounds check for the collision config.

Emits a text report (and with ``--json`` a JSON report), then exits 1 if
any finding is not covered by the port's own baseline
(``analysis_baseline_torch.json`` at the repo root, shipped empty: every
known finding is fixed or carries an inline suppression with a reason).
The reference's ``analysis_baseline.json`` belongs to ``repro``.  Loads
no JAX.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.analysis import contracts, kernel_budget, torchlint

REPO_ROOT = Path(__file__).resolve().parents[3]
DEFAULT_BASELINE = REPO_ROOT / "analysis_baseline_torch.json"
BASELINE_SCHEMA = "repro-torch-lint-baseline/v1"
REPORT_SCHEMA = "repro-torch-analysis/v1"


def load_baseline(path: Path) -> set[str]:
    if not path.exists():
        return set()
    doc = json.loads(path.read_text())
    if doc.get("schema") != BASELINE_SCHEMA:
        raise SystemExit(
            f"unrecognised baseline schema in {path}: {doc.get('schema')!r}")
    return set(doc.get("findings", []))


def run(
    paths: list[str] | None = None,
    *,
    with_kernels: bool = True,
    with_aer: bool = True,
    smem_budget: int = kernel_budget.DEFAULT_SMEM_BUDGET,
) -> dict:
    """Run the full pass; returns the report dict (no exit, no printing)."""
    lint_paths = [Path(p) for p in (paths or [REPO_ROOT / "src" / "repro_torch"])]
    result = torchlint.lint_paths(lint_paths, rel_to=REPO_ROOT)

    plans: list[kernel_budget.KernelPlan] = []
    if with_kernels:
        plans, kfindings = kernel_budget.check_kernel_budgets(
            smem_budget=smem_budget)
        result.findings.extend(kfindings)

    aer_report: dict | None = None
    if with_aer:
        from repro_torch.configs.collision_snn import CONFIG

        sizes = list(CONFIG.layer_sizes)
        aer_report = contracts.aer_bounds_report(sizes)
        for msg in contracts.check_aer_bounds(sizes):
            result.findings.append(torchlint.Finding(
                "src/repro_torch/events/aer.py", 1, 0, "RA401", msg))

    return {
        "schema": REPORT_SCHEMA,
        "paths": [str(p) for p in lint_paths],
        "findings": [f.to_json() for f in result.findings],
        "finding_keys": [f.key for f in result.findings],
        "suppressed": [f.to_json() for f in result.suppressed],
        "graph_bodies": list(result.graph_bodies),
        "counts": {
            "findings": len(result.findings),
            "suppressed": len(result.suppressed),
        },
        "kernels": [p.to_json() for p in plans],
        "kernel_report": [kernel_budget.render(p) for p in plans],
        "spill_allowance": {k: {"bytes": n, "reason": why} for k, (n, why)
                            in kernel_budget.SPILL_ALLOWANCE.items()},
        "aer_bounds": aer_report,
        "budgets": {"smem_bytes": smem_budget,
                    "threads": kernel_budget.MAX_THREADS,
                    "cluster": kernel_budget.MAX_CLUSTER},
    }


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis",
                                 description=__doc__)
    ap.add_argument("paths", nargs="*",
                    help="files/dirs to lint (default: src/repro_torch)")
    ap.add_argument("--json", dest="json_out", help="write the full JSON report here")
    ap.add_argument("--baseline", default=str(DEFAULT_BASELINE))
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to accept all current findings")
    ap.add_argument("--no-kernels", action="store_true",
                    help="skip the kernel budget checks")
    ap.add_argument("--no-aer", action="store_true", help="skip AER bounds checks")
    ap.add_argument("--smem-budget", type=int,
                    default=kernel_budget.DEFAULT_SMEM_BUDGET)
    args = ap.parse_args(argv)

    report = run(
        args.paths or None,
        with_kernels=not args.no_kernels,
        with_aer=not args.no_aer,
        smem_budget=args.smem_budget,
    )

    baseline_path = Path(args.baseline)
    baseline = load_baseline(baseline_path)
    new = [f for f, k in zip(report["findings"], report["finding_keys"])
           if k not in baseline]
    report["baseline"] = {
        "path": str(baseline_path),
        "entries": len(baseline),
        "new_findings": len(new),
    }
    report["counts"]["new"] = len(new)

    if args.update_baseline:
        baseline_path.write_text(json.dumps(
            {"schema": BASELINE_SCHEMA,
             "findings": sorted(set(report["finding_keys"]))}, indent=2) + "\n")
        print(f"baseline updated: {len(report['finding_keys'])} entries -> "
              f"{baseline_path}")

    if args.json_out:
        Path(args.json_out).write_text(json.dumps(report, indent=2) + "\n")

    for f in new:
        print(f"{f['path']}:{f['line']}:{f['col']}: {f['code']} {f['message']}")
    for body in report["graph_bodies"]:
        print(f"graph body: {body}")
    for line in report["kernel_report"]:
        print(line)
    unknown = [p for p in report["kernels"] if p["registers"] is None]
    if unknown:
        print(f"kernel budgets: {unknown[0]['ptxas']}")
    n_sup = report["counts"]["suppressed"]
    print(f"repro-lint: {len(new)} new finding(s), "
          f"{report['counts']['findings'] - len(new)} baselined, "
          f"{n_sup} suppressed")
    if new and not args.update_baseline:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
