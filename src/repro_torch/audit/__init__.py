"""Data-motion auditor (counterpart of ``repro.audit``).

``audit_step`` runs a step-factory product inside
:func:`~repro_torch.audit.record.recording` — a fake process group and
fake tensors: nothing is allocated and nothing moves — records every
collective it issues through :mod:`repro_torch.dist.comm`, attributes
each one to a :class:`~repro_torch.plan.PrecisionPlan` traffic class
from its dtype, shape and group, and pins the recorded wire bytes
against the analytic model (``PrecisionPlan.wire_table`` geometry). The
third byte pin beside measured and analytic: the program's own calls.
"""
from repro_torch.audit.audit import AuditError, AuditReport, ClassTotal, audit_step
from repro_torch.audit.record import Recording, collect_comm_calls, recording

__all__ = [
    "AuditError",
    "AuditReport",
    "ClassTotal",
    "Recording",
    "audit_step",
    "collect_comm_calls",
    "recording",
]
