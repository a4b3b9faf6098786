"""The diagnostics event log, spans and the counted host sync (port of the
parts of ``pycatkin_tpu/utils/profiling.py`` the serving path calls).

Events and spans go to the ambient :class:`..obs.trace.RunTrace` (the
process root trace when no ``obs.run_trace()`` context is open). The
serving path records its lifecycle there (``serve`` events: listen,
warm, reject, drain, flush failures), the coalescer its flushes
(``worker`` / ``pack-flush``) and the packed transient its non-finite
endpoints (``degradation`` / ``transient:nonfinite``).

:func:`host_sync` is the one counted device-to-host transfer of a
bundle: every tensor leaf of a (nested) tuple, list or dict is packed
into one byte buffer on its device and copied to the host in one
transfer, then unpacked into numpy arrays. It counts one sync in the
process-wide counter (:func:`sync_count`), in the ambient trace (for
:func:`sync_budget`) and in the ``pycatkin_host_syncs_total`` metric.
The solver loops count their own syncs in ``solvers.newton.SYNCS`` and
``solvers.ode.SYNCS``, as they did before this module existed.

``profile_trace`` and ``run_cprofiler`` are not ported yet.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

import numpy as np

from ..obs import metrics as _metrics
from ..obs import trace as _obs


def record_event(kind: str, **fields) -> dict:
    """Append one structured diagnostics event (``{'kind': kind, 't':
    monotonic seconds, **fields}``) to the ambient trace and return it."""
    return _obs.current_trace().record(kind, **fields)


def peek_events(kind: str | None = None) -> list:
    """The ambient trace's events recorded so far (optionally filtered
    by kind), without clearing them."""
    return _obs.current_trace().peek(kind)


def drain_events() -> list:
    """Return and clear the ambient trace's events."""
    return _obs.current_trace().drain()


@contextmanager
def span(label: str, **fields):
    """Wall-clock one region into the event log: records one ``{"kind":
    "span", "label": label, "dur": seconds}`` event on exit (exceptions
    included), with span and parent ids."""
    with _obs.trace_span(label, **fields):
        yield


_SYNC_LOCK = threading.Lock()
_SYNC_COUNT = 0
_SYNC_LABELS: list = []


def _leaves(value, out: list):
    """Every tensor leaf of a nested tuple / list / dict, in order."""
    import torch
    if isinstance(value, torch.Tensor):
        out.append(value)
    elif isinstance(value, dict):
        for v in value.values():
            _leaves(v, out)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _leaves(v, out)
    return out


def _rebuild(value, host: dict):
    """``value`` with every tensor leaf replaced by its host copy."""
    import torch
    if isinstance(value, torch.Tensor):
        return host[id(value)]
    if isinstance(value, dict):
        return {k: _rebuild(v, host) for k, v in value.items()}
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(_rebuild(v, host) for v in value))
    if isinstance(value, (tuple, list)):
        return type(value)(_rebuild(v, host) for v in value)
    if value is None or isinstance(value, (str, bytes)):
        return value
    return np.asarray(value)


def _to_host(tensors) -> dict:
    """``{id(t): numpy copy}`` for the tensors, in one transfer per
    device: each device's leaves are viewed as bytes, concatenated on
    that device, copied once and split on the host."""
    import torch
    host, by_dev = {}, {}
    for t in tensors:
        if id(t) in host:
            continue
        if t.device.type == "cpu":
            host[id(t)] = t.detach().numpy()
        else:
            by_dev.setdefault(t.device, []).append(t)
            host[id(t)] = None
    for ts in by_dev.values():
        flat = [t.detach().contiguous().reshape(-1).view(torch.uint8)
                for t in ts]
        buf = torch.cat(flat).cpu().numpy()
        at = 0
        for t, f in zip(ts, flat):
            n = f.numel()
            dtype = torch.empty(0, dtype=t.dtype).numpy().dtype
            host[id(t)] = buf[at:at + n].view(dtype).reshape(
                t.shape).copy()
            at += n
    return host


def host_sync(value, label: str = ""):
    """Move ``value`` to the host and count it once. ``value`` is a tensor
    (returns its numpy array) or a nested tuple / list / dict of them
    (returned with the same structure, every tensor leaf a numpy array,
    every other leaf as numpy would read it; None and strings stay).
    The tensors of one device cross in one transfer. ``label`` tags the
    site (:func:`sync_labels`)."""
    global _SYNC_COUNT
    with _SYNC_LOCK:
        _SYNC_COUNT += 1
        _SYNC_LABELS.append(label)
    _obs.note_sync(label)
    _metrics.counter("pycatkin_host_syncs_total",
                     "counted blocking device->host syncs").inc()
    t0 = time.perf_counter()
    try:
        leaves = _leaves(value, [])
        return _rebuild(value, _to_host(leaves))
    finally:
        _metrics.histogram(
            "pycatkin_host_sync_seconds",
            "blocked wall of each counted device->host sync",
        ).observe(time.perf_counter() - t0, label=label)


def sync_count() -> int:
    """Process-wide number of counted host syncs since the last
    :func:`reset_sync_count`."""
    return _SYNC_COUNT


def sync_labels() -> list:
    """Labels of the counted syncs since the last reset, in order."""
    return list(_SYNC_LABELS)


def reset_sync_count() -> int:
    """Zero the host-sync counter; returns the count it held."""
    global _SYNC_COUNT
    with _SYNC_LOCK:
        prior = _SYNC_COUNT
        _SYNC_COUNT = 0
        _SYNC_LABELS.clear()
    return prior


@contextmanager
def sync_budget():
    """Host syncs counted by :func:`host_sync` inside a block, against
    the ambient trace::

        with sync_budget() as b:
            ...
        assert b.count <= 1
    """
    class _Budget:
        count = 0
        labels: list = []
    b = _Budget()
    tr = _obs.current_trace()
    with tr.lock:
        start = tr.sync_count
        start_len = len(tr.sync_labels)
    try:
        yield b
    finally:
        with tr.lock:
            b.count = tr.sync_count - start
            b.labels = list(tr.sync_labels[start_len:])
