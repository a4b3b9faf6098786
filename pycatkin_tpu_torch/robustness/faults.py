"""Deterministic fault injection (port of ``pycatkin_tpu/robustness/
faults.py``).

A :class:`FaultPlan` names injection sites and fires scripted faults at
chosen occurrences, so every failure branch of the serving path is
testable: the server's ``serve:accept`` (admission) and
``serve:flush:<label>`` (one coalesced group's flush) sites, and the
``label`` of any :func:`..utils.retry.call_with_backend_retry` call.

Faults:

- ``transient``  -- raises :class:`InjectedTransientError`, a
  ``ConnectionResetError``, which :func:`..utils.retry.
  is_transient_backend_error` classifies transient (the port's only
  transient errors are transport ones).
- ``permanent``  -- raises :class:`InjectedDeviceLossError` (never
  transient): models device loss.
- ``nan``        -- poisons the result of a completed call: float
  tensors and arrays (optionally only chosen lanes of the leading axis)
  are overwritten with NaN.
- ``stall``      -- sleeps ``delay_s`` before the call proceeds.
- ``worker-crash``    -- SIGKILLs the calling process (a preempted
  worker).
- ``heartbeat-stall`` / ``slow-worker`` -- sleep ``delay_s`` at the
  site.
- ``replica-crash`` / ``replica-stall`` / ``conn-reset`` /
  ``torn-line`` / ``router-crash`` -- serve-tier kinds enacted by their
  caller through :func:`take`; :meth:`FaultPlan.on_call` never fires
  them.

Activation: pass a plan to :func:`fault_scope`. The port reads no
environment variable, so there is no plan without one; the JSON form of
the JAX package's ``PYCATKIN_FAULTS`` travels in a worker's config
instead (:meth:`FaultPlan.from_json`). With no plan active
every hook is a single ``is None`` check. A ``state_dir`` makes each
spec's ``times`` budget hold across every process sharing that
directory (ticket files created ``O_EXCL``).
"""

from __future__ import annotations

import fnmatch
import json
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

_KINDS = ("transient", "permanent", "nan", "stall",
          "worker-crash", "heartbeat-stall", "slow-worker",
          "replica-crash", "replica-stall", "conn-reset", "torn-line",
          "router-crash")

# Kinds enacted by the serve tier itself (fleet supervisor / front
# router) via take(), never by on_call.
EXTERNAL_KINDS = ("replica-crash", "replica-stall", "conn-reset",
                  "torn-line", "router-crash")


class InjectedDeviceLossError(RuntimeError):
    """Permanent injected failure (device loss). Not a transport error,
    so ``is_transient_backend_error`` never classifies it retryable."""


@dataclass(frozen=True)
class FaultSpec:
    """One scripted fault.

    site:    fnmatch pattern against the injection-site label (the
             server's ``"serve:accept"`` and ``"serve:flush:<label>"``,
             retry labels like ``"packed batched transient"``;
             ``"serve:flush:*"`` matches every flush).
    kind:    one of ``transient | permanent | nan | stall |
             worker-crash | heartbeat-stall | slow-worker``.
    index:   fire only at this occurrence of the site (0-based count
             of calls at that site, retries included); None = any.
    times:   maximum number of firings (None = unlimited; a permanent
             device loss is typically ``times=None``).
    lanes:   for 'nan': lane indices (leading axis) to poison;
             None = every lane.
    delay_s: for 'stall'/'heartbeat-stall'/'slow-worker': seconds to
             sleep before the call proceeds.
    """
    site: str
    kind: str
    index: int | None = None
    times: int | None = 1
    lanes: tuple | None = None
    delay_s: float = 0.0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {_KINDS})")
        if self.lanes is not None:
            object.__setattr__(self, "lanes", tuple(self.lanes))


class InjectedTransientError(ConnectionResetError):
    """Transient injected failure: a transport error by type, so
    ``is_transient_backend_error`` classifies it retryable."""


def _transient_error(site: str, occurrence: int):
    return InjectedTransientError(
        f"injected transient fault at site={site!r} "
        f"occurrence={occurrence} (connection reset)")


def _poison_leaf(x, lanes):
    import numpy as np
    import torch
    if isinstance(x, torch.Tensor):
        if x.dim() < 1 or not (x.is_floating_point() or x.is_complex()):
            return x
        x = x.clone()
    else:
        try:
            a = np.asarray(x)
        except Exception:
            return x
        if a.ndim < 1 or not np.issubdtype(a.dtype, np.inexact):
            return x
        x = np.array(a)                      # writable host copy
    if lanes is None:
        x[...] = float("nan")
    else:
        idx = [i for i in lanes if i < x.shape[0]]
        if idx:
            x[idx] = float("nan")
    return x


def _poison(tree, lanes):
    """NaN-overwrite the float leaves (tensors or arrays: whole, or the
    given leading-axis lanes) of a result made of dicts, lists, tuples
    and named tuples."""
    if isinstance(tree, dict):
        return {k: _poison(v, lanes) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_poison(v, lanes) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_poison(v, lanes) for v in tree)
    return _poison_leaf(tree, lanes)


class FaultPlan:
    """A deterministic schedule of faults over named injection sites.

    Occurrence counters advance per :meth:`on_call` at each site, so a
    spec with ``index=1, times=1`` fires exactly at the second call of
    its site (e.g. the first retry attempt) and never again. Thread-safe
    counter updates; the fired log (:attr:`log`) records every injection
    for test assertions.
    """

    def __init__(self, specs=(), state_dir: str | None = None):
        self.specs = [s if isinstance(s, FaultSpec) else FaultSpec(**s)
                      for s in specs]
        self.state_dir = None if state_dir is None else str(state_dir)
        self._calls: dict[str, int] = {}
        self._fired: dict[int, int] = {}
        self.log: list[dict] = []
        self._lock = threading.Lock()

    @classmethod
    def from_json(cls, data) -> "FaultPlan | None":
        """Build a plan from its JSON form (a string, or the object it
        parses to): a list of spec dicts, or ``{"specs": [...],
        "state_dir": ...}`` for fleet-wide budgets -- the form the JAX
        package reads from ``PYCATKIN_FAULTS``, which travels here in a
        worker's config instead. None or an empty string gives None."""
        if isinstance(data, (str, bytes)):
            if not data.strip():
                return None
            data = json.loads(data)
        if data is None:
            return None
        if isinstance(data, dict):
            return cls(data.get("specs", ()),
                       state_dir=data.get("state_dir"))
        return cls(data)

    def _acquire(self, i: int, spec: FaultSpec) -> bool:
        """Consume one firing of spec ``i`` (called under the lock,
        AFTER :meth:`_due` matched it). Per-process plans just count;
        with a ``state_dir`` a bounded spec must win an ``O_EXCL``
        ticket file, so at most ``times`` firings happen across every
        process sharing the directory -- first-claimer-wins, no
        cross-process lock needed."""
        if self.state_dir is None or spec.times is None:
            self._fired[i] = self._fired.get(i, 0) + 1
            return True
        os.makedirs(self.state_dir, exist_ok=True)
        for k in range(spec.times):
            path = os.path.join(self.state_dir, f"spec{i:03d}_fire{k:03d}")
            try:
                fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            except FileExistsError:
                continue
            os.write(fd, f"{os.getpid()}\n".encode())
            os.close(fd)
            self._fired[i] = self._fired.get(i, 0) + 1
            return True
        # Budget exhausted fleet-wide: remember locally so _due stops
        # offering this spec.
        self._fired[i] = spec.times
        return False

    def _due(self, site: str, occurrence: int, kinds) -> list[int]:
        due = []
        for i, spec in enumerate(self.specs):
            if spec.kind not in kinds:
                continue
            if not fnmatch.fnmatchcase(site, spec.site):
                continue
            if spec.index is not None and occurrence != spec.index:
                continue
            if spec.times is not None and \
                    self._fired.get(i, 0) >= spec.times:
                continue
            due.append(i)
        return due

    def on_call(self, site: str) -> int:
        """Injection hook BEFORE a dispatch at ``site``. May sleep
        (stall) and/or raise (transient/permanent). Returns the
        occurrence index consumed."""
        with self._lock:
            occ = self._calls.get(site, 0)
            self._calls[site] = occ + 1
            due = self._due(site, occ,
                            ("stall", "heartbeat-stall", "slow-worker",
                             "worker-crash", "transient", "permanent"))
            fired = []
            for i in due:
                spec = self.specs[i]
                if not self._acquire(i, spec):
                    continue
                self.log.append({"site": site, "occurrence": occ,
                                 "kind": spec.kind})
                fired.append(spec)
        # Act outside the lock (sleeps and raises must not serialize
        # other sites' bookkeeping).
        for spec in fired:
            if spec.kind in ("stall", "heartbeat-stall", "slow-worker"):
                time.sleep(spec.delay_s)
            elif spec.kind == "worker-crash":
                # Model an external SIGKILL (preemption / OOM-killer):
                # the process dies mid-lease with no chance to clean
                # up, which is exactly the failure the elastic
                # scheduler's lease expiry + requeue must absorb.
                import signal
                os.kill(os.getpid(), signal.SIGKILL)
            elif spec.kind == "transient":
                raise _transient_error(site, occ)
            else:
                raise InjectedDeviceLossError(
                    f"injected permanent device loss at site={site!r} "
                    f"occurrence={occ}")
        return occ

    def take(self, site: str, kinds=EXTERNAL_KINDS) -> list:
        """Consume due *externally-enacted* faults at ``site`` and
        return the fired :class:`FaultSpec` list WITHOUT acting on
        them: serve-tier kinds (replica-crash, conn-reset, ...) name
        effects only their caller can produce -- killing a replica
        subprocess, severing a routed connection -- so the caller
        enacts what comes back. Advances the site's occurrence counter
        and consumes ``times`` budgets (O_EXCL tickets under a
        ``state_dir``) exactly like :meth:`on_call`."""
        with self._lock:
            occ = self._calls.get(site, 0)
            self._calls[site] = occ + 1
            fired = []
            for i in self._due(site, occ, tuple(kinds)):
                spec = self.specs[i]
                if not self._acquire(i, spec):
                    continue
                self.log.append({"site": site, "occurrence": occ,
                                 "kind": spec.kind})
                fired.append(spec)
        return fired

    def on_result(self, site: str, out):
        """Injection hook AFTER a successful dispatch at ``site``:
        applies any due 'nan' poisoning to the result."""
        with self._lock:
            # The matching on_call already advanced the counter.
            occ = max(self._calls.get(site, 1) - 1, 0)
            due = self._due(site, occ, ("nan",))
            lanes = []
            for i in due:
                if not self._acquire(i, self.specs[i]):
                    continue
                self.log.append({"site": site, "occurrence": occ,
                                 "kind": "nan"})
                lanes.append(self.specs[i].lanes)
        for ln in lanes:
            out = _poison(out, ln)
        return out


# ---------------------------------------------------------------------
# Active-plan registry: one process-wide plan, set by fault_scope().
_ACTIVE: FaultPlan | None = None


def active_plan() -> FaultPlan | None:
    return _ACTIVE


@contextmanager
def fault_scope(plan: FaultPlan | None):
    """Install ``plan`` as the process-wide fault plan for the block
    (None disables injection)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = prev


def inject(site: str) -> None:
    """Module-level pre-dispatch hook: no-op without an active plan."""
    plan = active_plan()
    if plan is not None:
        plan.on_call(site)


def take(site: str, kinds=EXTERNAL_KINDS) -> list:
    """Module-level externally-enacted-fault hook (see
    :meth:`FaultPlan.take`): no-op empty list without an active plan."""
    plan = active_plan()
    if plan is None:
        return []
    return plan.take(site, kinds)


def transform(site: str, out):
    """Module-level post-dispatch hook: no-op without an active plan."""
    plan = active_plan()
    if plan is None:
        return out
    return plan.on_result(site, out)
