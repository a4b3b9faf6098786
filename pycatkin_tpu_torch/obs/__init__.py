"""Run-scoped observability: trace contexts, metrics and the run manifest
(port of the parts of ``pycatkin_tpu/obs`` the serving path calls).

- :mod:`.trace` -- nestable :class:`RunTrace` contexts (contextvars,
  thread-safe) behind ``utils.profiling``'s ``record_event`` / ``span``
  / ``host_sync`` / ``sync_budget``;
- :mod:`.metrics` -- a process-wide registry of counters, gauges and
  histograms, exportable as a JSON snapshot or Prometheus text;
- :mod:`.manifest` -- the self-describing run manifest every serve
  response carries.

The cost ledger, the exporters and the bench history
(``obs/{costs,export,history}``) are not ported (ROADMAP.md Queue A).
"""

from .manifest import run_manifest  # noqa: F401
from .metrics import (counter, default_registry, gauge,  # noqa: F401
                      histogram, prometheus_text,
                      validate_prometheus_text)
from .metrics import snapshot as metrics_snapshot  # noqa: F401
from .trace import (RunTrace, current_span_id, current_trace,  # noqa: F401
                    root_trace, run_trace)

__all__ = [
    "RunTrace", "run_trace", "current_trace", "current_span_id",
    "root_trace", "run_manifest", "counter", "gauge", "histogram",
    "default_registry", "metrics_snapshot", "prometheus_text",
    "validate_prometheus_text",
]
