"""Serving-contract audit of warmed steps (port of ``repro.analysis``'s
``hlo_audit``; see :mod:`repro_torch.analysis.audit`)."""
from repro_torch.analysis.audit import (AuditError, AuditReport, AuditSpec,
                                        Recorder, audit_step,
                                        note_collective,
                                        scorecard_budget_bytes)

__all__ = ["AuditError", "AuditReport", "AuditSpec", "Recorder",
           "audit_step", "note_collective", "scorecard_budget_bytes"]
