"""Analysis of the port (``repro.analysis``'s counterpart):

* :mod:`~repro_torch.analysis.audit`: the serving-contract audit of a
  warmed step (the torch meaning of ``hlo_audit``'s rules), wired into the
  engine as ``EngineConfig(audit=True)``;
* :mod:`~repro_torch.analysis.lint`: the trip-safety AST lint (host reads
  and syncs inside a trip, seed aliasing, bare kernel asserts, mutable
  defaults), run as ``python -m repro_torch.analysis.lint src/repro_torch
  --max-suppressions 0``;
* :mod:`~repro_torch.analysis.locks`: the thread-lockset pass over classes
  that declare ``THREAD_ENTRY_POINTS`` / ``GUARDED_BY`` (the serving
  engine), and :mod:`~repro_torch.analysis.recorder`, its run-time twin;
* :mod:`~repro_torch.analysis.accounting`: the launcher's per-device
  account of a step (exact placement bytes, FLOPs and bytes counted over
  a run on ``meta``, collectives reckoned from the specs): the accounting
  half of ``hlo_audit``.

``lint``, ``locks`` and ``recorder`` read source text or instrument an
object; none imports the code it checks.
"""
from repro_torch.analysis.audit import (AuditError, AuditReport, AuditSpec,
                                        Recorder, audit_step,
                                        note_collective,
                                        scorecard_budget_bytes)
from repro_torch.analysis.recorder import ThreadAccessRecorder

__all__ = ["AuditError", "AuditReport", "AuditSpec", "Recorder",
           "audit_step", "note_collective", "scorecard_budget_bytes",
           "ThreadAccessRecorder"]
