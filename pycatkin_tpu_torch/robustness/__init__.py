"""Failure subsystem (port of ``pycatkin_tpu/robustness``); the model in
``docs/failure_model.md`` holds for the port too:

- :mod:`.faults`  -- scripted transient/permanent/NaN/stall faults at
  named dispatch sites (:func:`faults.fault_scope`, or a worker config's
  plan), making every failure branch testable.
- :mod:`.ladder`  -- per-chunk escalation: bounded retry -> requeue on
  another card -> CPU host fallback -> salvage + structured report.
- :mod:`.journal` / :mod:`.chunked` -- append-only sweep journal and
  the resumable chunked sweep runner built on it.
- :mod:`.forensics` -- per-lane failure reports and the elastic
  worker-lifecycle summary.
- :mod:`.scheduler` -- elastic multi-process dispatch: lease-based
  work queue, worker supervision/restart, poison-span bisection and
  the chaos drill.
"""

from .chunked import (chunk_verdict, chunked_sweep_steady_state,
                      salvage_arrays)
from .faults import (FaultPlan, FaultSpec, InjectedDeviceLossError,
                     InjectedTransientError, fault_scope)
from .journal import (JournalMismatchError, SweepJournal,
                      conditions_fingerprint)
from .forensics import (format_failure_report, sweep_failure_report,
                        worker_lifecycle)
from .ladder import (ChunkAbandonedError, DegradationPolicy,
                     record_quarantine, run_chunk_with_ladder)
from .scheduler import WorkQueue, chaos_drill, run_elastic

__all__ = [
    "ChunkAbandonedError",
    "DegradationPolicy",
    "FaultPlan",
    "FaultSpec",
    "InjectedDeviceLossError",
    "InjectedTransientError",
    "JournalMismatchError",
    "SweepJournal",
    "WorkQueue",
    "chaos_drill",
    "chunk_verdict",
    "chunked_sweep_steady_state",
    "conditions_fingerprint",
    "fault_scope",
    "format_failure_report",
    "record_quarantine",
    "run_chunk_with_ladder",
    "run_elastic",
    "salvage_arrays",
    "sweep_failure_report",
    "worker_lifecycle",
]
