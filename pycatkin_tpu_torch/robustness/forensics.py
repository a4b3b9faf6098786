"""Host-side per-lane failure forensics for batched sweeps (port of
``pycatkin_tpu/robustness/forensics.py``).

A sweep that limps home (quarantined lanes, exhausted rescues, demoted
stability verdicts) must be able to say what happened to each lane
without anyone re-running it under a debugger. This module assembles the
forensic record from data the sweep already carries: the per-lane
diagnostics of the result dict (verdict-test breakdown, final residual,
iterations/attempts, PTC pseudo-step at exit), the quarantine mask and
the structured ladder/retry/quarantine events (:mod:`.ladder`,
``utils/profiling``), plus the elastic scheduler's worker events.

Everything is plain-JSON-serializable host data; tensors are read on the
host.
"""

from __future__ import annotations

import numpy as np

from ..obs.manifest import run_manifest

# Diagnostic keys lifted verbatim (as python scalars) from a sweep
# result dict into each lane report, when present.
_VERDICT_KEYS = ("rate_ok", "pos_ok", "sums_ok")
_SCALAR_KEYS = ("residual", "dt_exit")
_INT_KEYS = ("iterations", "attempts")
_BOOL_KEYS = ("success", "quarantined", "stable")


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy() if hasattr(a, "detach") else \
        np.asarray(a)


def _lane_conditions(conds, lane: int, n_lanes: int) -> dict:
    """Per-lane condition values: every field of the Conditions batched
    over the lane axis, as python scalars (or short lists), keyed by
    field name as the JAX package's pytree path names them."""
    out = {}
    for name, leaf in zip(conds._fields, conds):
        arr = _np(leaf)
        if arr.ndim == 0 or arr.shape[0] != n_lanes:
            continue
        val = arr[lane]
        if val.ndim == 0:
            out[name] = float(val)
        elif val.size <= 8:
            out[name] = [float(v) for v in val.ravel()]
    return out


def lane_report(out: dict, lane: int, conds=None,
                events: list | None = None) -> dict:
    """Forensic record for ONE lane of a sweep result dict.

    ``out`` is the dict returned by ``sweep_steady_state`` /
    ``chunked_sweep_steady_state`` (tensors or numpy arrays).
    ``events``: structured degradation/retry events; the lane's ladder
    history is the subset naming this lane (events carrying a ``lanes``
    list) plus every lane-anonymous event (chunk-level rungs apply to
    all their lanes).
    """
    n_lanes = len(_np(out["success"]))
    rep: dict = {"lane": int(lane)}
    for k in _BOOL_KEYS:
        if k in out:
            rep[k] = bool(_np(out[k])[lane])
    for k in _INT_KEYS:
        if k in out:
            rep[k] = int(_np(out[k])[lane])
    for k in _SCALAR_KEYS:
        if k in out:
            rep[k] = float(_np(out[k])[lane])
    verdict = {k: bool(_np(out[k])[lane])
               for k in _VERDICT_KEYS if k in out}
    if verdict:
        rep["verdict"] = verdict
    if "tof" in out:
        rep["tof"] = float(_np(out["tof"])[lane])
    if conds is not None:
        rep["conditions"] = _lane_conditions(conds, int(lane), n_lanes)
    if events is not None:
        rep["history"] = [ev for ev in events
                          if int(lane) in ev.get("lanes", [])
                          or "lanes" not in ev]
    return rep


def worker_lifecycle(events) -> dict:
    """Summarize an elastic run's worker-lifecycle events (the
    ``kind="worker"`` records of :mod:`.scheduler`: supervisor events
    from ``events.jsonl`` or ``report["events"]``): restarts, expired or
    stolen leases, bisected or quarantined spans. Zeros and empties for
    runs with no worker events."""
    evs = [e for e in (events or []) if e.get("kind") == "worker"]
    by_action: dict[str, list] = {}
    for e in evs:
        by_action.setdefault(e.get("action", "?"), []).append(e)

    def labels(action):
        return [e.get("label", "?") for e in by_action.get(action, [])]

    restarts: dict[str, int] = {}
    for e in by_action.get("restart", ()):
        lbl = e.get("label", "?")
        restarts[lbl] = restarts.get(lbl, 0) + 1
    return {
        "n_events": len(evs),
        "restarts": restarts,
        "n_restarts": sum(restarts.values()),
        "spawns": len(by_action.get("spawn", ())),
        "abandoned": labels("abandon"),
        "killed_stalled": labels("kill-stalled"),
        "leases_expired": labels("lease-expired"),
        "leases_stolen": [
            {"task": e.get("label"), "by": e.get("owner"),
             "from": e.get("stolen_from")}
            for e in by_action.get("lease-stolen", ())],
        "bisected": labels("task-bisected"),
        "quarantined": labels("task-quarantined"),
    }


def sweep_failure_report(out: dict, conds=None,
                         events: list | None = None,
                         max_lanes: int = 256, device=None) -> dict:
    """The end-of-sweep forensic report: one record per failed or
    quarantined lane (capped at ``max_lanes``; the cap is recorded so
    truncation is never silent), sweep-level counts, the full structured
    event log, the worker-lifecycle section and the run manifest of
    ``device`` (None: the CUDA card, as the entries resolve it).

    ``events`` should be the run's degradation/retry events -- e.g. a
    chunked run's ``report["events"]``, or the matching subset of
    ``utils.profiling.drain_events()`` for a plain sweep.
    """
    success = _np(out["success"]).astype(bool)
    n = len(success)
    quarantined = _np(out.get("quarantined", np.zeros(n))).astype(bool)
    bad = np.flatnonzero(~success | quarantined)
    return {
        "n_lanes": int(n),
        "n_failed": int(np.sum(~success)),
        "n_quarantined": int(np.sum(quarantined)),
        "quarantined_lanes": [int(i) for i in np.flatnonzero(quarantined)],
        "truncated": bool(len(bad) > max_lanes),
        "lanes": [lane_report(out, int(i), conds=conds, events=events)
                  for i in bad[:max_lanes]],
        "events": list(events or []),
        "worker_lifecycle": worker_lifecycle(events),
        "manifest": run_manifest(device=device),
    }


def format_failure_report(report: dict) -> str:
    """Human-readable rendering of :func:`sweep_failure_report`."""
    lines = [f"sweep forensics: {report['n_failed']} failed / "
             f"{report['n_quarantined']} quarantined of "
             f"{report['n_lanes']} lane(s)"]
    if report["quarantined_lanes"]:
        lines.append(f"  quarantined lanes: "
                     f"{report['quarantined_lanes']}")
    for rep in report["lanes"]:
        verdict = rep.get("verdict", {})
        failing = [k for k, v in verdict.items() if not v]
        bits = [f"lane {rep['lane']}:"]
        if rep.get("quarantined"):
            bits.append("QUARANTINED")
        bits.append("converged" if rep.get("success") else "failed")
        if failing:
            bits.append(f"failing tests: {', '.join(failing)}")
        if "residual" in rep:
            bits.append(f"residual {rep['residual']:.3g}")
        if "dt_exit" in rep:
            bits.append(f"dt_exit {rep['dt_exit']:.3g}")
        if "iterations" in rep:
            bits.append(f"{rep['iterations']} it / "
                        f"{rep.get('attempts', 0)} att")
        lines.append("  " + " ".join(bits))
        for key, val in rep.get("conditions", {}).items():
            lines.append(f"    {key} = {val}")
        for ev in rep.get("history", []):
            lines.append(f"    {ev.get('label', '?')}: "
                         f"{ev.get('rung', ev.get('kind', '?'))}: "
                         f"{ev.get('detail', '')}")
    if report.get("truncated"):
        lines.append(f"  (lane reports truncated at "
                     f"{len(report['lanes'])})")
    wl = report.get("worker_lifecycle") or {}
    if wl.get("n_events"):
        lines.append(f"  worker lifecycle: {wl['spawns']} spawn(s), "
                     f"{wl['n_restarts']} restart(s)")
        for lbl, cnt in sorted(wl.get("restarts", {}).items()):
            lines.append(f"    {lbl}: restarted {cnt}x")
        for lbl in wl.get("killed_stalled", []):
            lines.append(f"    {lbl}: killed for stalled heartbeat")
        for lbl in wl.get("leases_expired", []):
            lines.append(f"    {lbl}: lease expired, requeued")
        for st in wl.get("leases_stolen", []):
            lines.append(f"    {st.get('task')}: stolen by "
                         f"{st.get('by')} from {st.get('from')}")
        for lbl in wl.get("bisected", []):
            lines.append(f"    {lbl}: bisected and requeued")
        for lbl in wl.get("quarantined", []):
            lines.append(f"    {lbl}: quarantined at minimum size")
        for lbl in wl.get("abandoned", []):
            lines.append(f"    {lbl}: slot abandoned "
                         f"(restart budget exhausted)")
    return "\n".join(lines)
