"""Bounded retry on transient transport failures (port of the parts of
``pycatkin_tpu/utils/retry.py`` the serving path calls).

The JAX package retries compile-service and tunnel flakes of its
backend. The port has no such service: its kernels are built once per
process and a CUDA error leaves the context unusable, so no CUDA error
is transient and nothing retries on one. What stays transient is the
serve tier's transport, by exception type: a reset, refused or
half-read connection and a burned deadline
(:data:`TRANSIENT_CONNECTION_TYPES`), which the TCP client's reconnect
and :func:`call_with_backend_retry` absorb.

Backoff is full-jitter exponential (``sleep ~ U(0, min(cap, base *
2**i))``), and an optional overall ``deadline_s`` bounds the time spent
inside one retried unit. Every attempt also passes through the
fault-injection hooks (:mod:`..robustness.faults`) keyed by the call's
``label``.

:func:`classify_worker_exit` maps a worker subprocess's exit (the
elastic scheduler's and the static dispatcher's workers) onto the same
taxonomy: a signal death or a timeout is preemption-shaped and safe to
requeue; a nonzero exit status is a program error.
"""

from __future__ import annotations

import asyncio
import random
import signal
import sys
import time
from dataclasses import dataclass

# Exception types that are transient by construction: asyncio / socket
# transport failures at the serve tier. The peer (or the route to it)
# went away, not the program, and a re-sent sweep is deterministic.
TRANSIENT_CONNECTION_TYPES = (
    ConnectionResetError,
    ConnectionRefusedError,
    ConnectionAbortedError,
    BrokenPipeError,
    asyncio.IncompleteReadError,
    asyncio.TimeoutError,
    TimeoutError,
)

# Stop printing per-retry lines after this many within one call; a
# single summary line marks the suppression.
_LOG_CAP = 3

# Process-wide jitter source; call sites needing reproducible delays
# pass their own ``rng``.
_jitter_rng = random.Random()


def is_transient_backend_error(exc: BaseException) -> bool:
    """True when ``exc`` is a transport failure by type
    (:data:`TRANSIENT_CONNECTION_TYPES`). Everything else is a program
    or device error and is never re-run: a CUDA error in particular
    leaves the context lost, so a retry could only fail again or run on
    corrupted state."""
    return isinstance(exc, TRANSIENT_CONNECTION_TYPES)


def backoff_delay(attempt: int, base_delay_s: float,
                  max_delay_s: float, jitter: bool = True,
                  rng=None) -> float:
    """Full-jitter exponential backoff delay before retry ``attempt``
    (0-based): ``U(0, min(max_delay_s, base_delay_s * 2**attempt)]``
    when ``jitter`` is on, the deterministic cap otherwise."""
    delay = min(max_delay_s, base_delay_s * (2.0 ** attempt))
    if jitter:
        rng = rng if rng is not None else _jitter_rng
        delay = rng.uniform(0.0, delay)
    return delay


@dataclass(frozen=True)
class WorkerExit:
    """Classification of one worker subprocess exit into the retry
    taxonomy: ``transient`` deaths (signal death, timeout) are
    preemption-shaped -- re-dispatching the same block is pure, so a
    requeue or restart is always safe; a ``nonzero-exit`` is a program
    error (a re-run of the identical input will likely die again) and
    only counts toward poison-chunk bisection."""
    kind: str          # "ok" | "signal-death" | "nonzero-exit" | "timeout"
    transient: bool
    detail: str


def classify_worker_exit(returncode: int | None,
                         timed_out: bool = False) -> WorkerExit:
    """Map a subprocess return code (``Popen.returncode`` semantics:
    negative = killed by that signal) onto the retry taxonomy."""
    if timed_out:
        return WorkerExit("timeout", True,
                          "worker exceeded its deadline (treated like "
                          "DEADLINE_EXCEEDED: requeue-safe)")
    if returncode is None:
        return WorkerExit("ok", False, "worker still running")
    if returncode == 0:
        return WorkerExit("ok", False, "clean exit")
    if returncode < 0:
        try:
            name = signal.Signals(-returncode).name
        except ValueError:
            name = f"signal {-returncode}"
        return WorkerExit("signal-death", True,
                          f"killed by {name} (preemption-shaped: "
                          f"requeue-safe)")
    return WorkerExit("nonzero-exit", False,
                      f"exit status {returncode} (program error: "
                      f"re-run of the identical block may die again)")


def call_with_backend_retry(fn, *args, attempts: int = 3,
                            base_delay_s: float = 2.0,
                            max_delay_s: float = 60.0,
                            deadline_s: float | None = None,
                            jitter: bool = True, rng=None,
                            label: str = "", **kwargs):
    """Call ``fn(*args, **kwargs)``, retrying up to ``attempts`` total
    tries on transient errors (:func:`is_transient_backend_error`).

    Backoff before attempt ``i+1`` is :func:`backoff_delay` of ``i``.
    ``deadline_s`` bounds the total elapsed time across attempts and
    sleeps: when the next backoff would cross it, the current failure
    propagates instead. Non-transient exceptions propagate at once; the
    last transient failure propagates after the final attempt. The
    active fault plan's hooks run around every attempt at site
    ``label``."""
    from ..robustness import faults

    rng = rng if rng is not None else _jitter_rng
    start = time.monotonic()
    logged = 0
    for i in range(attempts):
        plan = faults.active_plan()
        try:
            if plan is not None:
                plan.on_call(label)
            out = fn(*args, **kwargs)
            if plan is not None:
                out = plan.on_result(label, out)
            return out
        except Exception as exc:  # noqa: BLE001 -- filtered below
            if i + 1 >= attempts or not is_transient_backend_error(exc):
                raise
            delay = backoff_delay(i, base_delay_s, max_delay_s,
                                  jitter=jitter, rng=rng)
            if deadline_s is not None and \
                    time.monotonic() - start + delay > deadline_s:
                raise
            from . import profiling
            from ..obs import metrics as _metrics
            profiling.record_event(
                "retry", label=label, attempt=i + 1, attempts=attempts,
                delay_s=round(delay, 3),
                error=str(exc).splitlines()[0][:200] if str(exc) else "")
            _metrics.counter("pycatkin_retry_attempts_total",
                             "transient backend errors absorbed by "
                             "the retry wrapper").inc()
            if logged < _LOG_CAP:
                print(f"transient error"
                      f"{f' in {label}' if label else ''}"
                      f" (attempt {i + 1}/{attempts}, retrying in "
                      f"{delay:.1f} s): {type(exc).__name__}: {exc}",
                      file=sys.stderr, flush=True)
                logged += 1
                if logged == _LOG_CAP and attempts - (i + 1) > 1:
                    print(f"(suppressing further retry logs"
                          f"{f' for {label}' if label else ''})",
                          file=sys.stderr, flush=True)
            time.sleep(delay)
    raise AssertionError("unreachable")      # pragma: no cover
