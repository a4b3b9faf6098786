"""Graceful-degradation ladder: escalate per chunk instead of crashing
(port of ``pycatkin_tpu/robustness/ladder.py``).

A failure that exhausts the bounded retry would kill the whole sweep.
This module turns per-chunk failure handling into an explicit policy
that escalates through rungs, each strictly cheaper in outcome but
strictly more likely to complete:

  1. **retry**          -- bounded full-jitter retry with an overall
                           deadline (utils/retry.py) on the original
                           device; absorbs transport flakes.
  2. **requeue**        -- re-dispatch the chunk on a DIFFERENT CUDA
                           device of the machine (one sick card should
                           not sink the run); skipped on a one-card
                           machine.
  3. **host fallback**  -- run the chunk on the CPU. On by default
                           only for a run on the CPU (where it re-runs
                           the chunk there, as the JAX package's CPU
                           runs do); a run on the card takes it only
                           when its policy opts in.
  4. **salvage**        -- mark the chunk's lanes failed and continue;
                           the sweep ends with a structured report of
                           degraded chunks instead of a dead process.

Every transition records a ``degradation`` event (in the ambient trace
of utils/profiling), counts ``pycatkin_ladder_rung_total{rung=...}``
and prints one stderr line, so a run that limped home says so -- the
host-fallback rung is a recorded degradation, never a silent one, and a
chunk that runs cleanly fires no rung at all.

A fault of the card itself -- the kernel library failing to build, load
or launch (``ops.cuda_linalg.KernelError``), or a CUDA runtime error --
is no chunk's fault: it propagates from every rung unhandled, so no rung
hides it behind a re-dispatch.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass

from ..obs import metrics as _metrics
from ..utils import profiling
from ..utils.retry import call_with_backend_retry


@dataclass(frozen=True)
class DegradationPolicy:
    """Per-chunk escalation policy.

    attempts/base_delay_s/max_delay_s/deadline_s parameterize rung 1's
    bounded retry (full-jitter exponential backoff, overall deadline);
    the booleans enable/disable the later rungs; ``host_fallback=None``
    enables the host fallback for a run on the CPU only, so a run on
    the card never comes back from the host unless it sets True.
    ``rung_attempts``
    bounds the retry wrapped around each requeue/host-fallback
    dispatch (those rungs still deserve flake absorption, but a
    cheaper one)."""
    attempts: int = 3
    base_delay_s: float = 1.0
    max_delay_s: float = 30.0
    deadline_s: float | None = None
    requeue: bool = True
    host_fallback: bool | None = None
    salvage: bool = True
    rung_attempts: int = 2


class ChunkAbandonedError(RuntimeError):
    """Every enabled rung failed and salvage is disabled."""


def record_quarantine(lanes, *, label: str = "quarantine:sweep",
                      detail: str = "", events: list | None = None):
    """The ``quarantine`` rung: per-LANE demotion, below the per-chunk
    rungs of :func:`run_chunk_with_ladder`.

    A lane whose results come back non-finite while flagged converged
    (a NaN-poisoned dispatch -- the one corruption the bool success
    flag cannot witness) is demoted to failed so the rescue ladder
    re-solves it and every downstream reduction ignores it. The event
    shape matches the chunk rungs' (`label`/`rung`/`detail`), so
    journaled runs fold quarantines into the same structured report,
    and the chunked runner marks affected chunks non-complete so a
    resume re-solves them. Returns the event dict."""
    lanes = [int(i) for i in lanes]
    ev = {"label": label, "rung": "quarantine",
          "detail": detail or f"{len(lanes)} non-finite converged-flagged "
                              f"lane(s) demoted: {lanes[:16]}"
                              f"{'...' if len(lanes) > 16 else ''}",
          "lanes": lanes}
    if events is not None:
        events.append(ev)
    profiling.record_event("degradation", **ev)
    _metrics.counter("pycatkin_ladder_rung_total",
                     "degradation-ladder rungs fired").inc(
                         rung="quarantine")
    _metrics.counter("pycatkin_quarantined_lanes_total",
                     "lanes NaN-quarantined by the sweep").inc(len(lanes))
    print(f"degradation[{label}]: quarantine: {ev['detail']}",
          file=sys.stderr, flush=True)
    return ev


def _local_devices():
    """The machine's CUDA devices, in index order (empty without
    CUDA)."""
    import torch
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def _home_device(device):
    """The run's device as a ``torch.device`` with its index: None is
    the CUDA card, as the port's entries resolve it."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device()
                           if torch.cuda.is_available() else 0)
    return dev


def _alternate_device(exclude):
    """A device of :func:`_local_devices` of ``exclude``'s type other
    than ``exclude`` (the run's device), or None when the machine has no
    second one."""
    for d in _local_devices():
        if d.type == exclude.type and d != exclude:
            return d
    return None


def _card_fault(exc: BaseException) -> bool:
    """Whether ``exc`` is a fault of the card, not of the chunk: the
    kernel library failing to build, load or launch, or a CUDA runtime
    error."""
    import torch
    from ..ops.cuda_linalg import KernelError
    return isinstance(exc, (KernelError,
                            getattr(torch, "AcceleratorError", KernelError)))


def _host_device():
    import torch
    return torch.device("cpu")


def _first_line(exc: BaseException) -> str:
    return f"{type(exc).__name__}: " + \
        (str(exc).splitlines() or [""])[0][:200]


def run_chunk_with_ladder(run, *, label: str,
                          policy: DegradationPolicy = DegradationPolicy(),
                          validate=None, events: list | None = None,
                          device=None):
    """Drive ``run`` through the degradation ladder.

    ``run(device=None)``: the chunk callable; ``device`` (a
    ``torch.device``) re-targets the dispatch for the requeue and
    host-fallback rungs. ``validate(out) -> str | None``: post-hoc
    verdict on a completed call (e.g. NaN-poisoned outputs); a non-None
    string escalates exactly like an exception. ``device``: the run's
    own device (None: the CUDA card); the requeue rung picks another
    device than it, and ``policy.host_fallback=None`` enables the host
    fallback only where it is the CPU. A card fault
    (:func:`_card_fault`) propagates from every rung.

    Returns ``(result, events)`` where ``result`` is None when the
    salvage rung was reached (the caller owns building salvage
    arrays). Raises :class:`ChunkAbandonedError` when salvage is
    disabled and every enabled rung failed.
    """
    events = [] if events is None else events

    def note(rung: str, detail: str):
        ev = {"label": label, "rung": rung, "detail": detail}
        events.append(ev)
        profiling.record_event("degradation", **ev)
        _metrics.counter("pycatkin_ladder_rung_total",
                         "degradation-ladder rungs fired").inc(rung=rung)
        print(f"degradation[{label}]: {rung}: {detail}",
              file=sys.stderr, flush=True)

    def attempt(rung: str, **kwargs):
        """One rung's dispatch (retry-wrapped) + validation. Returns
        (ok, out)."""
        out = call_with_backend_retry(
            run, attempts=(policy.attempts if rung == "retry"
                           else policy.rung_attempts),
            base_delay_s=policy.base_delay_s,
            max_delay_s=policy.max_delay_s,
            deadline_s=policy.deadline_s, label=label, **kwargs)
        bad = validate(out) if validate is not None else None
        if bad:
            note(rung, f"result rejected: {bad}")
            return False, None
        return True, out

    home = _home_device(device)
    host_fallback = (home.type == "cpu" if policy.host_fallback is None
                     else policy.host_fallback)
    t0 = time.monotonic()
    try:
        ok, out = attempt("retry")
        if ok:
            return out, events
    except Exception as exc:                 # noqa: BLE001 -- escalates
        if _card_fault(exc):
            raise
        note("retry", f"exhausted: {_first_line(exc)}")

    if policy.requeue:
        dev = _alternate_device(home)
        if dev is not None:
            note("requeue", f"re-dispatching on {dev}")
            try:
                ok, out = attempt("requeue", device=dev)
                if ok:
                    note("requeue", "recovered")
                    return out, events
            except Exception as exc:         # noqa: BLE001 -- escalates
                if _card_fault(exc):
                    raise
                note("requeue", f"failed: {_first_line(exc)}")

    if host_fallback:
        dev = _host_device()
        note("host-fallback", f"re-dispatching on {dev}")
        try:
            ok, out = attempt("host-fallback", device=dev)
            if ok:
                note("host-fallback", "recovered")
                return out, events
        except Exception as exc:             # noqa: BLE001 -- escalates
            note("host-fallback", f"failed: {_first_line(exc)}")

    if policy.salvage:
        note("salvage", f"marking lanes failed after "
                        f"{time.monotonic() - t0:.1f} s of escalation")
        return None, events
    raise ChunkAbandonedError(
        f"{label}: every enabled degradation rung failed and salvage "
        "is disabled")
