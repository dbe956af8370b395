"""repro-lint for the port: static analysis and contract checking, with
the names of the reference's ``repro.analysis``.

Two halves:

- :mod:`repro_torch.analysis.torchlint`: a dependency-free AST lint over
  ``src/repro_torch/**`` (host calls, host syncs and tensor branches in
  CUDA graph bodies, rebinding of a captured graph's buffers, donation
  misuse, float64, unused imports, unreachable code) with ``#
  repro-lint: disable=CODE -- reason`` suppressions.
- :mod:`repro_torch.analysis.contracts` /
  :mod:`repro_torch.analysis.kernel_budget`: runtime and launch contract
  checkers: graph re-capture detection, donation verification, AER
  address-width bounds, and each Hopper kernel's launch budget.

CLI: ``python -m repro_torch.analysis [--json report.json]`` exits
nonzero on any finding not in ``analysis_baseline_torch.json``.  The
reference's ``DEFAULT_VMEM_BUDGET`` has no Hopper counterpart.
"""

from repro_torch.analysis.contracts import (
    ContractViolation,
    RecompileDetector,
    aer_bounds_report,
    check_aer_bounds,
    donation_report,
    runtime_donation_check,
    verify_donation,
)
from repro_torch.analysis.kernel_budget import (
    DEFAULT_SMEM_BUDGET,
    KernelPlan,
    check_kernel_budgets,
)
from repro_torch.analysis.torchlint import (
    RULES,
    Finding,
    LintResult,
    lint_paths,
    lint_source,
)

__all__ = [
    "ContractViolation",
    "RecompileDetector",
    "aer_bounds_report",
    "check_aer_bounds",
    "donation_report",
    "runtime_donation_check",
    "verify_donation",
    "RULES",
    "Finding",
    "LintResult",
    "lint_paths",
    "lint_source",
    "DEFAULT_SMEM_BUDGET",
    "KernelPlan",
    "check_kernel_budgets",
]
