"""Deterministic node-level fault injection (crashes, blackouts, failover).

See :mod:`repro_torch.faults.process` for the fault classes and for the
crash-vs-erasure error-feedback semantics (residual lost on crash,
residual kept on link loss / straggler erasure).
"""
from .process import (  # noqa: F401
    FaultModel,
    describe_faults,
    quorum_close_time,
    time_key,
)

__all__ = ["FaultModel", "describe_faults", "quorum_close_time", "time_key"]
