"""Process-wide metrics registry: counters, gauges, histograms (port of
``pycatkin_tpu/obs/metrics.py``).

Instruments are pure host-side bookkeeping -- one lock and a dict update
per increment, no device work. The serving path feeds them (requests,
rejects, flushes, queue depth, request walls, kernel builds as
``pycatkin_compile_total``), and so do the counted host syncs of
:func:`..utils.profiling.host_sync`. Two export surfaces:

- :func:`snapshot` -- a JSON-able dict;
- :func:`prometheus_text` -- Prometheus text exposition (version
  0.0.4), checked by :func:`validate_prometheus_text`.

Metric names follow Prometheus convention (``pycatkin_*_total`` for
counters). The registry is process-wide and resettable (:func:`reset`)
so tests can assert exact deltas. Nothing here imports torch.
"""

from __future__ import annotations

import re
import threading

# Powers-of-ten seconds ladder: wide enough for both a 50 ms CPU smoke
# sweep and a multi-minute cold compile.
DEFAULT_BUCKETS = (0.001, 0.01, 0.1, 1.0, 10.0, 60.0, 600.0)

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _label_key(labels: dict) -> str:
    """Canonical, sorted ``k="v"`` encoding (also the snapshot key;
    empty string for an unlabeled sample)."""
    return ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))


class _Instrument:
    """One named metric; holds one value (or histogram state) per
    label-set under the registry lock."""

    kind = "untyped"

    def __init__(self, name: str, help_text: str, lock: threading.Lock):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.help = help_text
        self._lock = lock
        self._values: dict = {}   # guarded-by: _lock

    def _check_labels(self, labels: dict):
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"invalid label name {k!r}")

    def values(self) -> dict:
        with self._lock:
            return dict(self._values)


class Counter(_Instrument):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels):
        if amount < 0:
            raise ValueError("counters only go up")
        self._check_labels(labels)
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Gauge(_Instrument):
    kind = "gauge"

    def set(self, value: float, **labels):
        self._check_labels(labels)
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def inc(self, amount: float = 1.0, **labels):
        self._check_labels(labels)
        key = _label_key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount


class Histogram(_Instrument):
    kind = "histogram"

    def __init__(self, name, help_text, lock, buckets=DEFAULT_BUCKETS):
        super().__init__(name, help_text, lock)
        self.buckets = tuple(sorted(float(b) for b in buckets))

    def observe(self, value: float, **labels):
        self._check_labels(labels)
        key = _label_key(labels)
        value = float(value)
        with self._lock:
            st = self._values.get(key)
            if st is None:
                st = {"sum": 0.0, "count": 0,
                      "buckets": [0] * len(self.buckets)}
                self._values[key] = st
            st["sum"] += value
            st["count"] += 1
            for i, le in enumerate(self.buckets):
                if value <= le:
                    st["buckets"][i] += 1

    def observe_many(self, values, **labels):
        """Bulk-observe an array/iterable of values as ONE lock
        acquisition (the per-lane telemetry feed observes 10^4-10^5
        lane samples per sweep; a Python-loop ``observe`` per lane
        would dominate the host tail). Uses numpy's searchsorted when
        available, falling back to a pure-Python count."""
        self._check_labels(labels)
        key = _label_key(labels)
        try:
            import numpy as np
            vals = np.asarray(values, dtype=float).ravel()
            if vals.size == 0:
                return
            counts = np.searchsorted(np.sort(vals),
                                     np.asarray(self.buckets),
                                     side="right")
            total, n = float(vals.sum()), int(vals.size)
            per_bucket = [int(c) for c in counts]
        except ImportError:       # pure-Python fallback, same result
            vals = [float(v) for v in values]
            if not vals:
                return
            total, n = sum(vals), len(vals)
            per_bucket = [sum(1 for v in vals if v <= le)
                          for le in self.buckets]
        with self._lock:
            st = self._values.get(key)
            if st is None:
                st = {"sum": 0.0, "count": 0,
                      "buckets": [0] * len(self.buckets)}
                self._values[key] = st
            st["sum"] += total
            st["count"] += n
            for i, c in enumerate(per_bucket):
                st["buckets"][i] += c

    def values(self) -> dict:
        with self._lock:
            return {k: {"sum": st["sum"], "count": st["count"],
                        "buckets": list(st["buckets"])}
                    for k, st in self._values.items()}


class MetricsRegistry:
    """Get-or-create instrument registry; one per process by default
    (:data:`default_registry`), fresh instances for tests."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict = {}  # guarded-by: _lock

    def _get(self, cls, name, help_text, **kwargs):
        with self._lock:
            inst = self._metrics.get(name)
        if inst is not None:
            if not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {inst.kind}")
            return inst
        inst = cls(name, help_text, self._lock, **kwargs)
        with self._lock:
            return self._metrics.setdefault(name, inst)

    def counter(self, name: str, help_text: str = "") -> Counter:
        return self._get(Counter, name, help_text)

    def gauge(self, name: str, help_text: str = "") -> Gauge:
        return self._get(Gauge, name, help_text)

    def histogram(self, name: str, help_text: str = "",
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help_text, buckets=buckets)

    def reset(self):
        """Drop every instrument (tests assert exact deltas)."""
        with self._lock:
            self._metrics.clear()

    # -- exports -------------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-able ``{"counters": {name: {labelkey: value}}, ...}``."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            metrics = list(self._metrics.values())
        for m in metrics:
            out[m.kind + "s"][m.name] = m.values()
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition (0.0.4) of every instrument."""
        lines = []
        with self._lock:
            metrics = sorted(self._metrics.values(),
                             key=lambda m: m.name)
        for m in metrics:
            if m.help:
                lines.append(f"# HELP {m.name} {m.help}")
            lines.append(f"# TYPE {m.name} {m.kind}")
            vals = m.values()
            if isinstance(m, Histogram):
                for key, st in sorted(vals.items()):
                    cum = 0
                    for le, n in zip(m.buckets, st["buckets"]):
                        cum += n
                        lbl = (key + "," if key else "") + f'le="{le}"'
                        lines.append(
                            f"{m.name}_bucket{{{lbl}}} {cum}")
                    lbl = (key + "," if key else "") + 'le="+Inf"'
                    lines.append(
                        f"{m.name}_bucket{{{lbl}}} {st['count']}")
                    suffix = f"{{{key}}}" if key else ""
                    lines.append(f"{m.name}_sum{suffix} {st['sum']}")
                    lines.append(f"{m.name}_count{suffix} {st['count']}")
            else:
                for key, v in sorted(vals.items()):
                    suffix = f"{{{key}}}" if key else ""
                    lines.append(f"{m.name}{suffix} {v}")
        return "\n".join(lines) + "\n"


default_registry = MetricsRegistry()


def counter(name: str, help_text: str = "") -> Counter:
    return default_registry.counter(name, help_text)


def gauge(name: str, help_text: str = "") -> Gauge:
    return default_registry.gauge(name, help_text)


def histogram(name: str, help_text: str = "",
              buckets=DEFAULT_BUCKETS) -> Histogram:
    return default_registry.histogram(name, help_text, buckets=buckets)


def snapshot() -> dict:
    return default_registry.snapshot()


def prometheus_text() -> str:
    return default_registry.prometheus_text()


def reset():
    default_registry.reset()


# -- exposition lint ---------------------------------------------------
_SAMPLE_RE = re.compile(
    r"^[a-zA-Z_:][a-zA-Z0-9_:]*"                  # metric name
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"\n]*\""     # first label
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"\n]*\")*\})?"  # more labels
    r" (-?[0-9.]+([eE][-+]?[0-9]+)?|[+-]Inf|NaN)$")

_VALID_TYPES = frozenset({"counter", "gauge", "histogram", "summary",
                          "untyped"})


def validate_prometheus_text(text: str) -> list:
    """Lint one exposition blob; returns a list of problem strings
    (empty = valid). Checks line grammar, declared TYPEs, and that
    every histogram carries its ``+Inf`` bucket and ``_sum``/``_count``
    series -- the failure modes a hand-rolled exporter actually has."""
    problems = []
    if text and not text.endswith("\n"):
        problems.append("exposition must end with a newline")
    typed: dict = {}
    seen_hist_parts: dict = {}
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[1] not in ("HELP", "TYPE"):
                problems.append(f"line {i}: malformed comment: {line!r}")
            elif parts[1] == "TYPE":
                if len(parts) < 4 or parts[3] not in _VALID_TYPES:
                    problems.append(
                        f"line {i}: bad TYPE declaration: {line!r}")
                else:
                    typed[parts[2]] = parts[3]
            continue
        if not _SAMPLE_RE.match(line):
            problems.append(f"line {i}: malformed sample: {line!r}")
            continue
        name = re.split(r"[{ ]", line, 1)[0]
        for base, t in typed.items():
            if t == "histogram" and name.startswith(base + "_"):
                part = name[len(base) + 1:]
                if part in ("bucket", "sum", "count"):
                    parts = seen_hist_parts.setdefault(base, set())
                    parts.add(part)
                    if part == "bucket" and 'le="+Inf"' in line:
                        parts.add("+Inf")
    for base, t in typed.items():
        if t != "histogram":
            continue
        parts = seen_hist_parts.get(base, set())
        for need in ("bucket", "sum", "count", "+Inf"):
            if parts and need not in parts:
                problems.append(
                    f"histogram {base} missing {need} series")
    return problems
