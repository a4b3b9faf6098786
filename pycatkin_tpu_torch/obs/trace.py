"""Nestable run-scoped trace contexts, the ``RunTrace`` primitive (port
of ``pycatkin_tpu/obs/trace.py``).

One :class:`RunTrace` owns one run's telemetry: a thread-safe event list
(``{"kind": ..., "t": ..., **fields}`` dicts, as
:func:`..utils.profiling.record_event` writes them), span parenting, and
per-trace host-sync accounting. The ambient trace rides a
:mod:`contextvars` variable:

- with no ``run_trace()`` active, every call lands in the process root
  trace;
- inside ``with run_trace("trial 0") as tr:`` the same calls land in
  ``tr`` only, so two threads running under separate traces do not
  pollute each other's ``sync_budget``;
- worker threads see the trace of whoever submitted them only when the
  submitter propagates its context (``contextvars.copy_context()``); a
  thread pool inherits nothing by default.

Span parenting is context-local too: ``trace_span`` pushes its span id
onto a contextvar, so concurrently executing work becomes sibling spans
under the submitter's current span. Everything here is host-side
bookkeeping: no torch import, no device work.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time

_TRACE_IDS = itertools.count(1)

# Ambient trace + current span id. Default None (module root trace /
# no open span) so a fresh thread context degrades to legacy behavior.
_AMBIENT: contextvars.ContextVar = contextvars.ContextVar(
    "pycatkin_obs_trace", default=None)
_CURRENT_SPAN: contextvars.ContextVar = contextvars.ContextVar(
    "pycatkin_obs_span", default=None)


class RunTrace:
    """One run's telemetry scope: events, spans, per-trace syncs.

    All mutation happens under ``self.lock`` so dispatch workers and
    pipeline threads can record into the same trace concurrently.
    """

    def __init__(self, name: str = "run", parent: "RunTrace" = None):
        self.name = str(name)
        self.trace_id = next(_TRACE_IDS)
        self.parent = parent
        self.lock = threading.Lock()
        self.events: list = []       # guarded-by: lock
        self.sync_count = 0          # guarded-by: lock
        self.sync_labels: list = []  # guarded-by: lock
        # Monotonic base: Chrome-trace timestamps are exported relative
        # to this so a trace starts near ts=0.
        self.t0 = time.monotonic()
        self._span_ids = itertools.count(1)

    # -- event log (the legacy record/peek/drain contract) ------------
    def record(self, kind: str, **fields) -> dict:
        ev = {"kind": str(kind), "t": round(time.monotonic(), 3),
              **fields}
        with self.lock:
            self.events.append(ev)
        return ev

    def peek(self, kind: str | None = None) -> list:
        with self.lock:
            evs = list(self.events)
        if kind is None:
            return evs
        return [e for e in evs if e["kind"] == kind]

    def drain(self) -> list:
        with self.lock:
            out = list(self.events)
            self.events.clear()
        return out

    # -- per-trace sync accounting -------------------------------------
    def note_sync(self, label: str = "", span_id=None) -> None:
        """Count one host sync against THIS trace and record a ``sync``
        instant event (carrying the enclosing span for the trace tree).
        """
        with self.lock:
            self.sync_count += 1
            self.sync_labels.append(label)
            self.events.append({
                "kind": "sync", "t": round(time.monotonic(), 3),
                "label": str(label), "ts": round(time.monotonic(), 6),
                "parent_id": span_id,
                "tid": threading.get_ident()})

    def next_span_id(self) -> int:
        with self.lock:
            return next(self._span_ids)


# The process root trace: where everything lands when no run_trace()
# is active (i.e. exactly the old module-global behavior).
_ROOT = RunTrace("root")


def root_trace() -> RunTrace:
    return _ROOT


def current_trace() -> RunTrace:
    """The ambient trace (root fallback -- never None)."""
    tr = _AMBIENT.get()
    return tr if tr is not None else _ROOT


def current_span_id():
    """Span id of the innermost open span in this context, or None."""
    return _CURRENT_SPAN.get()


@contextlib.contextmanager
def run_trace(name: str = "run"):
    """Open a run-scoped trace; every ``record_event``/``span``/
    ``host_sync``/``sync_budget`` call in this context (and in contexts
    copied from it) lands here instead of the root trace::

        with run_trace("trial 0") as tr:
            sweep_steady_state(...)
        chrome = chrome_trace(tr)
    """
    parent = _AMBIENT.get()
    tr = RunTrace(name, parent=parent)
    tok = _AMBIENT.set(tr)
    # A new trace starts its own span tree.
    tok_span = _CURRENT_SPAN.set(None)
    try:
        yield tr
    finally:
        _CURRENT_SPAN.reset(tok_span)
        _AMBIENT.reset(tok)


@contextlib.contextmanager
def trace_span(label: str, **fields):
    """The span primitive behind ``utils.profiling.span``: records ONE
    legacy-shaped span event on exit (``label``/``dur`` plus ``t``),
    extended with ``span_id``/``parent_id``/``t0``/``tid`` so exporters
    can rebuild the tree and the timeline. Exceptions still record (a
    span that died shows how long it ran)."""
    tr = current_trace()
    sid = tr.next_span_id()
    parent = _CURRENT_SPAN.get()
    tok = _CURRENT_SPAN.set(sid)
    t0_wall = time.perf_counter()
    t0_mono = time.monotonic()
    try:
        yield
    finally:
        _CURRENT_SPAN.reset(tok)
        tr.record("span", label=str(label),
                  dur=round(time.perf_counter() - t0_wall, 6),
                  span_id=sid, parent_id=parent,
                  t0=round(t0_mono, 6),
                  tid=threading.get_ident(), **fields)


def note_sync(label: str = "") -> None:
    """Count one host sync against the ambient trace (called by
    ``utils.profiling.host_sync`` IN ADDITION to the process-wide
    counter, which stays authoritative for ``sync_count()``)."""
    current_trace().note_sync(label, span_id=_CURRENT_SPAN.get())
