"""Chunked, journaled, degradation-tolerant steady-state sweeps (port of
``pycatkin_tpu/robustness/chunked.py``).

Lanes are split into chunks; every chunk runs through the full sweep
(:func:`..parallel.batch.sweep_steady_state`: fast pass, rescue ladder,
optional stability verdict) under the graceful-degradation ladder
(:mod:`.ladder`), and each finished chunk is journaled (:mod:`.journal`)
so a killed run resumes by re-dispatching only unfinished chunks, with
results bit-identical to an uninterrupted run (chunks are independent and
the ``.npz`` round trip is lossless).

Fault-injection sites: each chunk dispatch passes through
``faults.inject("chunk:<i>")`` / ``faults.transform("chunk:<i>", out)``
besides the retry-label sites inside the sweep itself, so a transient
flake, NaN poisoning, a stall or a permanent loss can be scripted at an
exact chunk.
"""

from __future__ import annotations

import contextvars
import sys

import numpy as np

from ..solvers.newton import SolverOptions
from ..utils.profiling import host_sync, span
from . import faults
from .journal import SweepJournal, conditions_fingerprint
from .ladder import (DegradationPolicy, _home_device,
                     run_chunk_with_ladder)


def chunk_verdict(out) -> str | None:
    """Post-hoc validation of one chunk's sweep result: a chunk whose
    'converged' lanes carry non-finite solutions was poisoned upstream
    and must escalate rather than enter the journal as good data."""
    y = np.asarray(out["y"])
    succ = np.asarray(out["success"]).astype(bool)
    if succ.any() and not np.all(np.isfinite(y[succ])):
        n = int(np.sum(~np.isfinite(y[succ]).all(axis=-1)))
        return f"{n} converged lane(s) carry non-finite y"
    return None


def salvage_arrays(spec, n_lanes: int, tof_mask=None,
                   check_stability: bool = False) -> dict:
    """All-lanes-failed result block for a salvaged chunk (same keys,
    shapes and dtypes as a real sweep result on the host)."""
    out = {
        "y": np.full((n_lanes, spec.n_species), np.nan),
        "success": np.zeros(n_lanes, dtype=bool),
        "residual": np.full(n_lanes, np.inf),
        "iterations": np.zeros(n_lanes, dtype=np.int64),
        "attempts": np.zeros(n_lanes, dtype=np.int64),
        "quarantined": np.zeros(n_lanes, dtype=bool),
        "rate_ok": np.zeros(n_lanes, dtype=bool),
        "pos_ok": np.zeros(n_lanes, dtype=bool),
        "sums_ok": np.zeros(n_lanes, dtype=bool),
        "dt_exit": np.full(n_lanes, np.nan),
        "chords": np.zeros(n_lanes, dtype=np.int32),
    }
    # Packed per-lane telemetry (iterations, chords, residual decade,
    # strategy, tier): never solved, so 0 iterations/chords, the +99
    # non-finite decade, the clean strategy code and tier 0.
    tel = np.zeros((n_lanes, 5), dtype=np.int32)
    tel[:, 2] = 99
    out["lane_telemetry"] = tel
    if check_stability:
        out["stable"] = np.zeros(n_lanes, dtype=bool)
    if tof_mask is not None:
        out["tof"] = np.full(n_lanes, np.nan)
        out["activity"] = np.full(n_lanes, np.nan)
    return out


def chunked_sweep_steady_state(spec, conds, *, chunk: int = 4096,
                               tof_mask=None,
                               opts: SolverOptions = SolverOptions(),
                               check_stability: bool = False,
                               pos_jac_tol: float = 1e-2,
                               journal: str | SweepJournal | None = None,
                               resume: bool = False,
                               policy: DegradationPolicy | None = None,
                               verbose: bool = False,
                               pipeline: bool = False,
                               mesh=None, abi: bool = False, device=None,
                               tier: str = "f64"):
    """Run ``sweep_steady_state`` chunk by chunk with journaling and
    graceful degradation.

    ``journal``: directory path (or an open :class:`SweepJournal`) for
    the on-disk journal; None runs unjournaled (ladder only).
    ``resume``: replay an existing journal, re-dispatching only chunks
    without a completed record. ``policy``: the degradation ladder
    configuration; ``policy.salvage=False`` restores fail-fast
    semantics (the journal still preserves completed chunks for a
    later resume). ``abi``, ``device`` and ``tier`` are passed to every
    chunk's sweep (``device=None``: the CUDA card); the ladder's
    requeue and host-fallback rungs re-target ``device``.

    Returns ``(out, report)``: ``out`` is the assembled result dict
    (host numpy arrays, original lane order); ``report`` is the
    structured end-of-run degradation report::

        {"n_chunks": ..., "chunk": ..., "reused": [ids],
         "degraded": [ids], "salvaged": [ids], "quarantined": [ids],
         "n_failed_lanes": ..., "events": [...]}

    A chunk with quarantined lanes that stayed failed after the rescue
    ladder is journaled with status ``"quarantined"`` -- like
    ``"salvaged"``, not a completed status, so a resume re-solves
    exactly the lanes that degraded. So is a chunk of a run on the card
    that the ladder's host fallback recovered (only where ``policy``
    opts the card run in): it is journaled ``"host-fallback"``, and a
    resume solves it on the card again.

    ``pipeline``: one-deep double buffer -- chunk ``k+1`` is solved on a
    single worker thread (which also pulls its results to the host)
    while the main thread triages and journals chunk ``k``. Solves stay
    serialized and journal records are written in chunk order from the
    main thread, so results are bit-identical to the serial loop; under
    an active fault plan (whose per-site occurrence drills assume solve
    and triage interleave strictly) the serial loop runs instead. Off
    by default (the JAX package's default is on): on an H100 the serial
    loop was the faster at 16,384 lanes a chunk (PERF.md).

    ``mesh`` (multi-device lane sharding) is not ported and must be
    None.
    """
    from ..parallel.batch import sweep_steady_state
    from ..parallel.dispatch import host_conditions

    if mesh is not None:
        raise NotImplementedError(
            "chunked_sweep_steady_state: multi-device lane sharding is "
            "not ported yet (ROADMAP Queue A item 12)")
    policy = policy or DegradationPolicy()
    home = device
    on_card = _home_device(device).type == "cuda"
    conds_np = host_conditions(conds)
    n = conds_np.T.shape[0]
    chunk = max(1, min(int(chunk), n))
    n_chunks = -(-n // chunk)

    jr = journal
    if isinstance(journal, (str, bytes)) or hasattr(journal, "__fspath__"):
        extra = (repr(opts), bool(check_stability), float(pos_jac_tol),
                 int(chunk), None if tof_mask is None
                 else np.asarray(tof_mask).tolist())
        if abi or tier != "f64":
            # Only a run off the JAX package's defaults extends the
            # fingerprint, which otherwise equals the JAX package's.
            extra += (("abi", bool(abi)), ("tier", str(tier)))
        fp = conditions_fingerprint(conds_np, extra=extra)
        jr = SweepJournal(str(journal), fingerprint=fp, n_lanes=n,
                          chunk=chunk, resume=resume, device=device)
    done = jr.completed() if jr is not None else {}

    report = {"n_chunks": n_chunks, "chunk": chunk, "reused": [],
              "degraded": [], "salvaged": [], "quarantined": [],
              "events": []}

    def solve_chunk(ci: int):
        """Dispatch one chunk through the full sweep and the ladder, its
        result pulled to the host (the pipelined half: no journal or
        report access in here)."""
        a, b = ci * chunk, min(n, (ci + 1) * chunk)
        site = f"chunk:{ci}"
        sub = type(conds_np)(*(v[a:b] for v in conds_np))

        def run(device=None):
            faults.inject(site)
            out = sweep_steady_state(
                spec, sub, tof_mask=tof_mask, opts=opts,
                check_stability=check_stability, pos_jac_tol=pos_jac_tol,
                abi=abi, tier=tier, device=home if device is None else device)
            out = host_sync(out, f"chunk {ci} results")
            return faults.transform(site, out)

        with span("chunk solve", chunk=ci, lanes=b - a):
            return run_chunk_with_ladder(run, label=site, policy=policy,
                                         validate=chunk_verdict,
                                         device=home)

    todo = [ci for ci in range(n_chunks) if ci not in done]
    use_pipeline = (pipeline and len(todo) > 1
                    and faults.active_plan() is None)
    executor = None
    futures: dict = {}
    if use_pipeline:
        from concurrent.futures import ThreadPoolExecutor
        executor = ThreadPoolExecutor(max_workers=1)

        def submit_chunk(ci):
            # A pool thread starts with an empty contextvars context;
            # copying the submitter's keeps the chunk's spans and syncs
            # in the caller's trace.
            return executor.submit(
                contextvars.copy_context().run, solve_chunk, ci)

        futures[todo[0]] = submit_chunk(todo[0])

    parts: list[dict] = []
    try:
        for ci in range(n_chunks):
            a, b = ci * chunk, min(n, (ci + 1) * chunk)
            if ci in done:
                parts.append(jr.load_chunk(done[ci]))
                report["reused"].append(ci)
                continue
            if executor is not None:
                nxt = todo.index(ci) + 1
                if nxt < len(todo):
                    futures[todo[nxt]] = submit_chunk(todo[nxt])
                out, events = futures.pop(ci).result()
            else:
                out, events = solve_chunk(ci)
            parts.append(_triage_chunk(ci, a, b, out, events, spec,
                                       tof_mask, check_stability, jr,
                                       report, n_chunks, verbose, on_card))
    finally:
        if executor is not None:
            for fut in futures.values():
                fut.cancel()
            executor.shutdown(wait=True)

    out = {k: np.concatenate([p[k] for p in parts], axis=0)
           for k in parts[0].keys()}
    report["n_failed_lanes"] = int(
        np.sum(~np.asarray(out["success"], dtype=bool)))
    return out, report


def _triage_chunk(ci, a, b, out, events, spec, tof_mask,
                  check_stability, jr, report, n_chunks, verbose,
                  on_card=False):
    """Main-thread half of the chunk loop: salvage/quarantine triage,
    journal record (always written in chunk order) and reporting, shared
    by the double-buffered and serial loops. ``on_card``: the run's
    device is a CUDA card, so a chunk its host fallback recovered is not
    complete."""
    site = f"chunk:{ci}"
    if out is None:
        out = salvage_arrays(spec, b - a, tof_mask, check_stability)
        status = "salvaged"
        report["salvaged"].append(ci)
    else:
        status = "done"
        if events:
            report["degraded"].append(ci)
        if on_card and any(e["rung"] == "host-fallback"
                           and e["detail"] == "recovered" for e in events):
            status = "host-fallback"
        # Quarantined lanes that the rescue ladder could not re-converge
        # leave the chunk incomplete: record the quarantine rung against
        # this chunk's site and journal a non-"done" status so a resume
        # re-solves those lanes.
        quar = np.asarray(out.get("quarantined", np.zeros(b - a)),
                          dtype=bool)
        succ = np.asarray(out["success"], dtype=bool)
        if (quar & ~succ).any():
            lanes = (a + np.flatnonzero(quar & ~succ)).tolist()
            events.append({
                "label": site, "rung": "quarantine",
                "detail": f"{len(lanes)} quarantined lane(s) "
                          f"unrecovered; chunk left incomplete "
                          f"for resume", "lanes": lanes})
            status = "quarantined"
            report["quarantined"].append(ci)
    n_failed = int(np.sum(~np.asarray(out["success"], dtype=bool)))
    if jr is not None:
        jr.record_chunk(ci, a, b, status, arrays=out, events=events,
                        n_failed=n_failed)
    report["events"].extend(events)
    if verbose:
        print(f"chunk {ci + 1}/{n_chunks} [{a}:{b}] {status} "
              f"({n_failed} failed lane(s))", file=sys.stderr, flush=True)
    return out
