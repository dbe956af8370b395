"""Runtime contract checkers of the port (``contracts``): graph
re-capture detection, donation verification and AER address-width
bounds, with the names of the reference's ``repro.analysis.contracts``.
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

__all__ = [
    "ContractViolation",
    "RecompileDetector",
    "aer_bounds_report",
    "check_aer_bounds",
    "donation_report",
    "runtime_donation_check",
    "verify_donation",
]
