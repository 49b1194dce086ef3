"""The real-time driver's fault boundary: failure taxonomy, retry
policy, fault injection and the quarantine ledger."""

from tpudas_torch.resilience.faults import (
    FAULT_SITES,
    FaultBoundary,
    FaultPlan,
    FaultSpec,
    RetryPolicy,
    SpoolReadError,
    TransientFaultError,
    classify_failure,
    fault_point,
    install_fault_plan,
)
from tpudas_torch.resilience.quarantine import (
    QUARANTINE_FILENAME,
    QuarantineLedger,
)

__all__ = [
    "FAULT_SITES",
    "FaultBoundary",
    "FaultPlan",
    "FaultSpec",
    "QUARANTINE_FILENAME",
    "QuarantineLedger",
    "RetryPolicy",
    "SpoolReadError",
    "TransientFaultError",
    "classify_failure",
    "fault_point",
    "install_fault_plan",
]
