"""Elastic sweep scheduler: lease-based work queue and worker supervision
(port of ``pycatkin_tpu/robustness/scheduler.py``).

Worker death is a requeue, not a failure: the lane grid becomes a shared
work queue of spans, worker subprocesses lease spans, and a lost worker
costs one span of work.

The coordination substrate is the filesystem: leases are files, so the
protocol is process- and host-agnostic, and every state transition is a
crash-atomic primitive:

  claim    write tmp record, ``os.link(tmp, lease)`` -- an atomic
           first-wins create; losers see ``FileExistsError``.
  renew    heartbeat thread rewrites the lease (tmp + ``os.replace``)
           every ``heartbeat_s``; a renewal that finds the lease gone
           or re-owned reports the loss (fencing) instead of writing.
  steal    a lease whose deadline passed is ``os.unlink``ed (exactly
           one racer wins) and then re-claimed through the normal claim
           path.
  done     result ``.npz`` written atomically (utils.io
           ``atomic_save_results``), then a done record created
           exclusively -- first completion wins.

The one unfenceable race -- a stalled owner renewing over a thief's
fresh lease -- is benign: both run the identical lane span through the
same deterministic sweep, result writes are atomic with bit-identical
payloads, and the exclusive done record dedupes the completion.

Supervision: :func:`run_elastic` spawns N worker subprocesses
(``python -m pycatkin_tpu_torch.robustness.scheduler <cfg>``, started
with ``subprocess``, never forked from a process holding a CUDA
context), polls them, classifies every exit
(``utils.retry.classify_worker_exit``) and restarts dead workers with
bounded full-jitter backoff. A worker that dies holding a valid lease
implicates its task: after ``max_kills`` such deaths the task is bisected
and requeued until the span reaches ``min_chunk``, then quarantined
through ``ladder.record_quarantine``. An expired lease whose owner is
still alive (a stalled heartbeat) gets the owner killed and restarted.

Workers: each reads the mechanism through the port's loader and runs the
port's ``sweep_steady_state`` on the ``device`` and ``abi`` its JSON
config names (``device=None``: the CUDA card; with several
cards, worker ``i`` takes card ``i`` modulo their count; workers on one
card share it, one CUDA context each), after loading the kernel library
(``cuda_linalg.load()``, counted by ``pycatkin_compile_total``) before
its first task.

Chaos: the fault kinds ``worker-crash`` / ``heartbeat-stall`` /
``slow-worker`` fire at the worker sites ``worker:<i>``, ``lease:<tid>``
and ``heartbeat:<i>``, from a fault plan in the worker's config (the JSON
form of the JAX package's ``PYCATKIN_FAULTS``, given to
:func:`run_elastic` as ``fault_plan``; the supervisor's own process runs
no plan). The fleet-wide ticket budget (``state_dir``) keeps a
``times=1`` crash from re-firing in every restarted incarnation.

Every lifecycle transition (spawn/exit/restart, lease granted/expired/
stolen, bisection, quarantine) is appended to ``events.jsonl`` in the
work directory (which opens with a run-manifest header), recorded as a
``kind="worker"`` event in the ambient trace and counted by the six
``pycatkin_elastic_*`` counters. The JAX package's
``PYCATKIN_ELASTIC_*`` knobs are :func:`run_elastic`'s keywords.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np

from ..utils.retry import backoff_delay, classify_worker_exit

EVENTS = "events.jsonl"
_STOP = "stop"
_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


# ---------------------------------------------------------------------
# Pure lease/task math (unit-tested directly; ``now`` is always a
# parameter so tests never sleep).

def task_id(start: int, stop: int) -> str:
    """Span-encoding task id (``t00004_00008`` = lanes [4, 8)). The id
    IS the lane range, so an fnmatch fault-site pattern like
    ``lease:t00004_*`` keeps matching the poisoned data as bisection
    splits the span into children."""
    return f"t{int(start):05d}_{int(stop):05d}"


def parse_task_id(tid: str) -> tuple[int, int]:
    a, b = tid[1:].split("_")
    return int(a), int(b)


def lease_record(owner: str, ttl_s: float, now: float,
                 stolen_from: str | None = None) -> dict:
    """A fresh lease: ``deadline`` is wall-clock (``time.time`` --
    leases must be comparable across processes and hosts, which
    monotonic clocks are not), renewed by rewriting the record."""
    rec = {"owner": str(owner), "granted": float(now),
           "deadline": float(now) + float(ttl_s), "ttl_s": float(ttl_s)}
    if stolen_from:
        rec["stolen_from"] = str(stolen_from)
    return rec


def lease_expired(lease: dict, now: float) -> bool:
    return float(now) >= float(lease.get("deadline", -np.inf))


def bisect_span(start: int, stop: int, min_chunk: int):
    """Midpoint of a poison-suspect span, or None when either child
    would fall under ``min_chunk`` (the quarantine floor). A width of
    exactly ``2 * min_chunk`` still splits -- the floor bounds child
    size, not parent size."""
    if stop - start < 2 * max(1, int(min_chunk)):
        return None
    return (start + stop) // 2


def _write_json(path: str, record: dict) -> None:
    """Crash-atomic small-file write (tmp + rename), the same pattern
    as the result payloads -- a reader never sees a torn record."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        json.dump(record, fh, sort_keys=True)
    os.replace(tmp, path)


def _read_json(path: str):
    try:
        with open(path) as fh:
            return json.load(fh)
    except (FileNotFoundError, json.JSONDecodeError):
        # A concurrently-replaced file can briefly read torn only on
        # non-POSIX rename semantics; treat like absent and let the
        # caller's next poll see the settled state.
        return None


class WorkQueue:
    """One elastic sweep's on-disk queue (a directory).

    Layout::

        tasks/<tid>.json    span + kill count (supervisor-maintained)
        leases/<tid>.lease  current owner + deadline
        results/<tid>.npz   atomic result payload
        done/<tid>.json     completion record (O_EXCL, first wins)
        events.jsonl        supervisor-written lifecycle journal
        stop                cooperative shutdown marker

    Workers and the supervisor share this class; every mutation is one
    of the crash-atomic primitives in the module docstring.
    """

    def __init__(self, root: str):
        self.root = str(root)
        self.tasks_dir = os.path.join(self.root, "tasks")
        self.leases_dir = os.path.join(self.root, "leases")
        self.results_dir = os.path.join(self.root, "results")
        self.done_dir = os.path.join(self.root, "done")

    def setup(self) -> "WorkQueue":
        for d in (self.tasks_dir, self.leases_dir, self.results_dir,
                  self.done_dir):
            os.makedirs(d, exist_ok=True)
        return self

    # -- paths ---------------------------------------------------------
    def task_path(self, tid: str) -> str:
        return os.path.join(self.tasks_dir, f"{tid}.json")

    def lease_path(self, tid: str) -> str:
        return os.path.join(self.leases_dir, f"{tid}.lease")

    def result_path(self, tid: str) -> str:
        return os.path.join(self.results_dir, f"{tid}.npz")

    def done_path(self, tid: str) -> str:
        return os.path.join(self.done_dir, f"{tid}.json")

    # -- task table ----------------------------------------------------
    def add_task(self, start: int, stop: int, kills: int = 0) -> str:
        tid = task_id(start, stop)
        _write_json(self.task_path(tid),
                    {"tid": tid, "start": int(start), "stop": int(stop),
                     "kills": int(kills)})
        return tid

    def remove_task(self, tid: str) -> None:
        try:
            os.unlink(self.task_path(tid))
        except FileNotFoundError:
            pass

    def tasks(self) -> dict:
        out = {}
        for name in sorted(os.listdir(self.tasks_dir)):
            if not name.endswith(".json"):
                continue
            rec = _read_json(os.path.join(self.tasks_dir, name))
            if rec is not None:
                out[rec["tid"]] = rec
        return out

    # -- leases --------------------------------------------------------
    def claim(self, tid: str, owner: str, ttl_s: float,
              now: float | None = None,
              stolen_from: str | None = None) -> bool:
        """Atomically claim ``tid``: True iff this caller won. The
        lease is materialized with ``os.link`` (hard-link create fails
        if the name exists), the one portable first-wins primitive that
        also carries a payload."""
        now = time.time() if now is None else now
        rec = lease_record(owner, ttl_s, now, stolen_from=stolen_from)
        tmp = os.path.join(self.leases_dir, f".claim.{owner}.{tid}.tmp")
        with open(tmp, "w") as fh:
            json.dump(rec, fh, sort_keys=True)
        try:
            os.link(tmp, self.lease_path(tid))
            return True
        except FileExistsError:
            return False
        finally:
            os.unlink(tmp)

    def read_lease(self, tid: str):
        return _read_json(self.lease_path(tid))

    def leases(self) -> dict:
        out = {}
        for name in sorted(os.listdir(self.leases_dir)):
            if not name.endswith(".lease"):
                continue
            rec = _read_json(os.path.join(self.leases_dir, name))
            if rec is not None:
                out[name[:-len(".lease")]] = rec
        return out

    def renew(self, tid: str, owner: str, ttl_s: float,
              now: float | None = None) -> bool:
        """Extend ``owner``'s lease on ``tid``; False means the lease
        was lost (stolen or released) and the caller must treat its
        work as speculative -- the fencing read. (The read-then-replace
        window can overwrite a thief's lease; see the module docstring
        for why that race is benign.)"""
        now = time.time() if now is None else now
        cur = self.read_lease(tid)
        if cur is None or cur.get("owner") != owner:
            return False
        rec = lease_record(owner, ttl_s, now,
                           stolen_from=cur.get("stolen_from"))
        rec["granted"] = cur.get("granted", rec["granted"])
        _write_json(self.lease_path(tid), rec)
        return True

    def release(self, tid: str, owner: str) -> None:
        cur = self.read_lease(tid)
        if cur is not None and cur.get("owner") == owner:
            try:
                os.unlink(self.lease_path(tid))
            except FileNotFoundError:
                pass

    def requeue(self, tid: str) -> bool:
        """Unlink ``tid``'s lease (expiry requeue / steal step 1).
        True iff this caller did the unlink -- exactly one concurrent
        requeuer wins, so a steal never double-counts."""
        try:
            os.unlink(self.lease_path(tid))
            return True
        except FileNotFoundError:
            return False

    def claim_next(self, owner: str, ttl_s: float,
                   now: float | None = None):
        """Claim the first available task in id order: unleased tasks
        first; then expired leases are stolen (unlink + claim).
        Returns ``(tid, stolen_from)`` or None when nothing is
        claimable right now."""
        now = time.time() if now is None else now
        done = set(self.done())
        for tid in sorted(self.tasks()):
            if tid in done:
                continue
            cur = self.read_lease(tid)
            if cur is None:
                if self.claim(tid, owner, ttl_s, now):
                    return tid, None
                continue
            if lease_expired(cur, now) and self.requeue(tid) and \
                    self.claim(tid, owner, ttl_s, now,
                               stolen_from=cur.get("owner")):
                return tid, cur.get("owner")
        return None

    # -- completion ----------------------------------------------------
    def write_done(self, tid: str, record: dict) -> bool:
        """Create ``tid``'s completion record exclusively: False means
        another completer already won (benign duplicate)."""
        path = self.done_path(tid)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as fh:
            json.dump(record, fh, sort_keys=True)
        try:
            os.link(tmp, path)
            return True
        except FileExistsError:
            return False
        finally:
            os.unlink(tmp)

    def done(self) -> dict:
        out = {}
        for name in sorted(os.listdir(self.done_dir)):
            if not name.endswith(".json"):
                continue
            rec = _read_json(os.path.join(self.done_dir, name))
            if rec is not None:
                out[name[:-len(".json")]] = rec
        return out

    # -- shutdown ------------------------------------------------------
    def request_stop(self) -> None:
        # Existence-only marker: readers test os.path.exists and never
        # parse the content, so a torn write is indistinguishable from
        # a complete one.
        with open(os.path.join(self.root, _STOP), "w") as fh:
            fh.write("stop\n")

    def stop_requested(self) -> bool:
        return os.path.exists(os.path.join(self.root, _STOP))


# ---------------------------------------------------------------------
# Coverage: the sweep is complete when done spans tile [0, n). Spans
# form a binary bisection hierarchy, so overlaps are exact-subset
# (a stalled owner completing a parent AFTER its children were
# re-solved); preferring the widest span at each boundary resolves
# them deterministically.

def covering_spans(done_records, n: int):
    """Minimal ordered list of done records tiling ``[0, n)``, or None
    while coverage is incomplete."""
    spans = sorted(((int(r["start"]), int(r["stop"]), r)
                    for r in done_records), key=lambda s: (s[0], -s[1]))
    cur, out = 0, []
    for a, b, rec in spans:
        if b <= cur:
            continue                         # fully covered already
        if a > cur:
            return None                      # gap -- keep working
        out.append((a, b, rec))
        cur = b
    return out if cur >= n else None


def stderr_tail(path: str, max_lines: int = 12) -> list[str]:
    try:
        with open(path, "rb") as fh:
            fh.seek(0, os.SEEK_END)
            fh.seek(max(0, fh.tell() - 16384))
            text = fh.read().decode("utf-8", "replace")
    except OSError:
        return []
    lines = [ln for ln in text.splitlines() if ln.strip()]
    return lines[-max_lines:]


# ---------------------------------------------------------------------
# Worker side.

class _Heartbeat(threading.Thread):
    """Renews one lease every ``interval_s`` until stopped. Runs the
    ``heartbeat:<i>`` fault site before each renewal, so a scripted
    ``heartbeat-stall`` blocks exactly the renewals while the worker
    thread keeps solving -- the live-but-expired state the supervisor
    must detect. A failed renewal sets :attr:`lost` (the fencing signal)
    and ends the thread."""

    def __init__(self, queue: WorkQueue, tid: str, owner: str,
                 idx: int, ttl_s: float, interval_s: float):
        super().__init__(daemon=True, name=f"heartbeat-{tid}")
        self.queue, self.tid, self.owner = queue, tid, owner
        self.idx, self.ttl_s, self.interval_s = idx, ttl_s, interval_s
        self.lost = threading.Event()
        self._halt = threading.Event()
        # Renewal bookkeeping is read by the owning worker thread while
        # this thread writes it.
        self._stats_lock = threading.Lock()
        self._renewals = 0           # guarded-by: _stats_lock

    def run(self):
        from . import faults
        while not self._halt.wait(self.interval_s):
            faults.inject(f"heartbeat:{self.idx}")
            if self._halt.is_set():
                return
            if not self.queue.renew(self.tid, self.owner, self.ttl_s):
                self.lost.set()
                return
            with self._stats_lock:
                self._renewals += 1

    def renewals(self) -> int:
        """How many times this lease has been renewed so far."""
        with self._stats_lock:
            return self._renewals

    def halt(self):
        self._halt.set()


def _worker_device(device, idx: int):
    """The device of worker ``idx``: ``device`` as given, except that
    the unindexed card (None or ``"cuda"``) becomes card ``idx`` modulo
    the machine's count."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("elastic worker: no CUDA device is "
                               "available; pass device='cpu'")
        dev = torch.device("cuda", idx % torch.cuda.device_count())
    return dev


def _worker_main(cfg_path: str) -> None:
    """One elastic worker process: claim -> heartbeat -> sweep ->
    atomic result -> done record, until coverage is complete or the
    stop marker appears. Crashing (injected or real) at any point is
    safe: the lease expires and the span is re-solved elsewhere."""
    with open(cfg_path) as fh:
        cfg = json.load(fh)
    from . import faults
    with faults.fault_scope(faults.FaultPlan.from_json(cfg.get("faults"))):
        _worker_loop(cfg)


def _worker_loop(cfg: dict) -> None:
    idx = int(cfg["worker"])
    q = WorkQueue(cfg["work_dir"])
    owner = f"w{idx}-{os.getpid()}"
    ttl_s = float(cfg["ttl_s"])
    heartbeat_s = float(cfg["heartbeat_s"])
    poll_s = float(cfg["poll_s"])
    n_lanes = int(cfg["n_lanes"])

    from .. import engine
    from ..frontend.loader import read_from_input_file
    from ..parallel.batch import sweep_steady_state
    from ..parallel.dispatch import load_conditions
    from ..utils.io import atomic_save_results
    from ..utils.profiling import host_sync, span
    from . import faults

    device = _worker_device(cfg.get("device"), idx)
    sim = read_from_input_file(cfg["model"], device=device)
    conds = load_conditions(cfg["conds"])
    mask = (engine.tof_mask_for(sim.spec, cfg["tof_terms"])
            if cfg.get("tof_terms") else None)
    check_stability = bool(cfg.get("check_stability", False))
    warmed = False

    while True:
        if q.stop_requested():
            return
        if covering_spans(q.done().values(), n_lanes) is not None:
            return
        claimed = q.claim_next(owner, ttl_s)
        if claimed is None:
            time.sleep(poll_s)
            continue
        tid, stolen_from = claimed
        start, stop = parse_task_id(tid)
        hb = _Heartbeat(q, tid, owner, idx, ttl_s, heartbeat_s)
        hb.start()
        try:
            # Fault sites, broad to narrow: worker:<i> models
            # whole-worker carnage (preemption, stragglers); lease:<tid>
            # models data-poisoned spans -- the id encodes the lane
            # range, so the pattern follows the poison through
            # bisection.
            faults.inject(f"worker:{idx}")
            faults.inject(f"lease:{tid}")
            sub = type(conds)(**{
                f: np.asarray(getattr(conds, f))[start:stop]
                for f in conds._fields})
            if not warmed and device.type == "cuda":
                # The kernel library's build or load, once per process
                # (a restarted worker pays it again).
                from ..ops import cuda_linalg
                with span("worker kernel load", worker=idx):
                    cuda_linalg.load()
                warmed = True
            with span("elastic task", worker=idx, task=tid,
                      lanes=stop - start):
                out = sweep_steady_state(
                    sim.spec, sub, tof_mask=mask,
                    check_stability=check_stability,
                    abi=bool(cfg.get("abi", False)), device=device)
            out = host_sync(out, "elastic task results")
            out = faults.transform(f"lease:{tid}", out)
            atomic_save_results(q.result_path(tid), out)
            q.write_done(tid, {
                "tid": tid, "start": start, "stop": stop,
                "status": "done", "owner": owner, "worker": idx,
                "stolen_from": stolen_from,
                "renewals": hb.renewals(),
                "n_failed": int(np.sum(~np.asarray(out["success"],
                                                   dtype=bool)))})
        finally:
            hb.halt()
            q.release(tid, owner)


# ---------------------------------------------------------------------
# Supervisor side.

class _Slot:
    """One worker slot's supervision state (the slot persists across
    restarts; the process does not)."""

    def __init__(self, idx: int):
        self.idx = idx
        self.proc: subprocess.Popen | None = None
        self.pid: int | None = None
        self.incarnation = -1
        self.restarts = 0
        self.next_spawn: float | None = 0.0   # due immediately
        self.abandoned = False
        self.self_killed = False

    @property
    def owner(self) -> str:
        return f"w{self.idx}-{self.pid}"


def run_elastic(sim, conds, *, n_workers: int = 2,
                chunk: Optional[int] = None,
                work_dir: Optional[str] = None,
                tof_terms=None, check_stability: bool = False,
                worker_env: Optional[dict] = None,
                ttl_s: float = 30.0,
                heartbeat_s: Optional[float] = None,
                min_chunk: int = 1,
                max_kills: int = 2,
                max_restarts: int = 8,
                restart_base_s: float = 0.5,
                restart_max_s: float = 8.0,
                timeout: Optional[float] = None,
                poll_s: float = 0.2,
                resume: bool = False,
                fault_plan=None, device=None, abi: bool = False):
    """Elastically dispatch ``sweep_steady_state`` over ``conds``.

    Returns ``(out, report)``: ``out`` matches the in-process sweep
    (host numpy, lane order preserved; quarantined spans carry
    ``chunked.salvage_arrays`` rows); ``report`` is the structured
    lifecycle summary (restarts, lease traffic, bisections,
    quarantines, per-exit classifications) that forensics renders.

    The supervisor touches no device. ``heartbeat_s`` defaults to
    ``ttl_s / 4``; ``chunk`` defaults to ~2 tasks per worker so there is
    slack to steal. ``resume=True`` reuses completed spans in an
    existing ``work_dir`` and re-runs the rest (quarantined spans get a
    fresh chance -- a wider re-solved parent takes precedence at
    merge). ``device`` (None: the CUDA card) and ``abi`` go to every
    worker's ``sweep_steady_state``; ``fault_plan`` (a
    :class:`~.faults.FaultPlan`'s JSON form: a list of spec dicts or
    ``{"specs": [...], "state_dir": ...}``) is installed in every
    worker; ``worker_env`` adds environment variables to the workers'.
    The JAX package's ``aot_cache`` is not taken: the port has no AOT
    executable cache (ROADMAP.md Queue A item 12f).
    """
    import tempfile

    from ..obs import metrics as _metrics
    from ..obs.manifest import run_manifest
    from ..utils.io import append_json_line
    from ..utils.profiling import record_event, span
    from .chunked import salvage_arrays
    from .ladder import record_quarantine

    ttl_s = float(ttl_s)
    heartbeat_s = ttl_s / 4.0 if heartbeat_s is None else float(heartbeat_s)
    min_chunk, max_kills = int(min_chunk), int(max_kills)
    max_restarts = int(max_restarts)
    from ..parallel.dispatch import host_conditions
    conds = host_conditions(conds)

    own_dir = work_dir is None
    if own_dir:
        work_dir = tempfile.mkdtemp(prefix="pycatkin_elastic_")
    q = WorkQueue(work_dir).setup()
    if q.done() and not resume:
        raise RuntimeError(
            f"elastic work dir {work_dir} already holds completed "
            "tasks; pass resume=True to continue it (or use a fresh "
            "directory)")

    from ..utils.io import save_system_json
    from ..parallel.dispatch import save_conditions

    model_path = os.path.join(work_dir, "model.json")
    conds_path = os.path.join(work_dir, "conds.npz")
    save_system_json(sim, model_path)
    save_conditions(conds_path, conds)

    n = len(np.asarray(conds.T))
    if chunk is None:
        chunk = max(min_chunk, -(-n // max(1, 2 * n_workers)))
    chunk = max(1, min(int(chunk), n))

    events_path = os.path.join(work_dir, EVENTS)
    counters = {
        "granted": _metrics.counter(
            "pycatkin_elastic_leases_granted_total",
            "work-queue leases observed granted"),
        "expired": _metrics.counter(
            "pycatkin_elastic_leases_expired_total",
            "leases that hit their deadline and were requeued"),
        "stolen": _metrics.counter(
            "pycatkin_elastic_leases_stolen_total",
            "expired leases re-claimed by a different worker"),
        "restarts": _metrics.counter(
            "pycatkin_elastic_worker_restarts_total",
            "dead/stalled workers restarted by the supervisor"),
        "bisected": _metrics.counter(
            "pycatkin_elastic_tasks_bisected_total",
            "poison-suspect tasks split and requeued"),
        "quarantined": _metrics.counter(
            "pycatkin_elastic_tasks_quarantined_total",
            "minimum-size tasks quarantined after repeated kills"),
    }
    report = {"n_lanes": n, "chunk": int(chunk), "n_workers": n_workers,
              "ttl_s": ttl_s, "heartbeat_s": heartbeat_s,
              "restarts": 0, "exits": [], "leases": {
                  "granted": 0, "expired": 0, "stolen": 0},
              "bisected": [], "quarantined": [], "events": []}

    def emit(action: str, label: str, **fields):
        ev = {"kind": "worker", "action": action, "label": label,
              "t": time.time(), **fields}
        append_json_line(events_path, ev)
        record_event("worker", action=action, label=label, **fields)
        report["events"].append(ev)
        return ev

    if not os.path.exists(events_path):
        append_json_line(events_path, {
            "kind": "header", "manifest": run_manifest(), "n_lanes": n,
            "chunk": int(chunk), "n_workers": n_workers})

    done0 = q.done()
    for a in range(0, n, chunk):
        tid = task_id(a, min(n, a + chunk))
        if tid not in done0 or resume and \
                done0[tid].get("status") == "quarantined":
            if tid in done0:                  # re-arm a quarantined span
                os.unlink(q.done_path(tid))
            q.add_task(a, min(n, a + chunk))

    slots = [_Slot(i) for i in range(n_workers)]
    seen_leases: set[tuple] = set()
    counted_done: set[str] = set()
    deadline = (time.monotonic() + timeout) if timeout else None

    def spawn(slot: _Slot):
        slot.incarnation += 1
        slot.self_killed = False
        cfg = {"work_dir": work_dir, "worker": slot.idx,
               "incarnation": slot.incarnation, "model": model_path,
               "conds": conds_path, "n_lanes": n, "ttl_s": ttl_s,
               "heartbeat_s": heartbeat_s, "poll_s": poll_s,
               "tof_terms": list(tof_terms) if tof_terms else None,
               "check_stability": bool(check_stability),
               "device": None if device is None else str(device),
               "abi": bool(abi), "faults": fault_plan}
        cfg_path = os.path.join(work_dir, f"worker_{slot.idx}.json")
        _write_json(cfg_path, cfg)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_PARENT, env.get("PYTHONPATH")) if p)
        if worker_env:
            env.update({k: str(v) for k, v in worker_env.items()})
        stderr_path = os.path.join(
            work_dir, f"worker_{slot.idx}.stderr.log")
        with open(stderr_path, "ab") as errf:
            slot.proc = subprocess.Popen(
                [sys.executable, "-m",
                 "pycatkin_tpu_torch.robustness.scheduler", cfg_path],
                env=env, cwd=os.getcwd(), stderr=errf)
        slot.pid = slot.proc.pid
        slot.next_spawn = None
        emit("spawn", f"worker:{slot.idx}", pid=slot.pid,
             incarnation=slot.incarnation)

    def implicate(tid: str, owner: str, why: str):
        """A worker died holding a valid lease on ``tid``: charge the
        task one kill, requeue it, and bisect/quarantine past the
        budget."""
        done = q.done()
        q.requeue(tid)
        if tid in done:
            return
        task = q.tasks().get(tid)
        if task is None:
            return
        start, stop = int(task["start"]), int(task["stop"])
        kills = int(task.get("kills", 0)) + 1
        q.add_task(start, stop, kills=kills)    # rewrite with new count
        emit("task-killed", f"lease:{tid}", kills=kills, cause=why,
             owner=owner)
        if kills < max_kills:
            return
        mid = bisect_span(start, stop, min_chunk)
        if mid is not None:
            q.add_task(start, mid)
            q.add_task(mid, stop)
            q.remove_task(tid)
            counters["bisected"].inc()
            report["bisected"].append(tid)
            emit("task-bisected", f"lease:{tid}", mid=mid,
                 children=[task_id(start, mid), task_id(mid, stop)])
        elif q.write_done(tid, {"tid": tid, "start": start,
                                "stop": stop, "status": "quarantined",
                                "kills": kills}):
            q.remove_task(tid)
            counters["quarantined"].inc()
            report["quarantined"].append(tid)
            ev = record_quarantine(range(start, stop),
                                   label=f"lease:{tid}",
                                   detail=f"span killed {kills} "
                                          f"worker(s) at minimum size")
            append_json_line(events_path, {"kind": "worker",
                                           "action": "task-quarantined",
                                           "label": f"lease:{tid}",
                                           "t": time.time(), **ev})
            report["events"].append(ev)

    def scan_leases(now: float):
        for tid, lease in q.leases().items():
            key = (tid, lease.get("owner"))
            if key not in seen_leases:
                seen_leases.add(key)
                counters["granted"].inc()
                report["leases"]["granted"] += 1
                if lease.get("stolen_from"):
                    counters["stolen"].inc()
                    report["leases"]["stolen"] += 1
                    emit("lease-stolen", f"lease:{tid}",
                         owner=lease.get("owner"),
                         stolen_from=lease.get("stolen_from"))
            if not lease_expired(lease, now):
                continue
            if not q.requeue(tid):
                continue                      # a worker stole it first
            counters["expired"].inc()
            report["leases"]["expired"] += 1
            emit("lease-expired", f"lease:{tid}",
                 owner=lease.get("owner"))
            # A live owner that let its lease lapse is a stalled
            # heartbeat: kill it (the work is requeued; the process is
            # not trustworthy) and let the restart path revive it.
            for slot in slots:
                if slot.proc is not None and slot.proc.poll() is None \
                        and slot.owner == lease.get("owner"):
                    slot.self_killed = True
                    emit("kill-stalled", f"worker:{slot.idx}",
                         task=tid)
                    slot.proc.kill()

    def note_done():
        for tid, rec in q.done().items():
            if tid in counted_done or rec.get("status") != "done":
                continue
            counted_done.add(tid)
            key = (tid, rec.get("owner"))
            if key not in seen_leases:        # completed between scans
                seen_leases.add(key)
                counters["granted"].inc()
                report["leases"]["granted"] += 1
                if rec.get("stolen_from"):
                    counters["stolen"].inc()
                    report["leases"]["stolen"] += 1
                    emit("lease-stolen", f"lease:{tid}",
                         owner=rec.get("owner"),
                         stolen_from=rec.get("stolen_from"))
            emit("task-done", f"lease:{tid}", owner=rec.get("owner"),
                 n_failed=rec.get("n_failed"))

    def handle_exit(slot: _Slot, now: float):
        rc = slot.proc.returncode
        exit_info = classify_worker_exit(rc)
        tail = stderr_tail(os.path.join(
            work_dir, f"worker_{slot.idx}.stderr.log"))
        report["exits"].append({
            "worker": slot.idx, "incarnation": slot.incarnation,
            "returncode": rc, "kind": exit_info.kind,
            "detail": exit_info.detail, "self_killed": slot.self_killed,
            "stderr_tail": tail})
        emit("exit", f"worker:{slot.idx}", returncode=rc,
             exit_kind=exit_info.kind, incarnation=slot.incarnation)
        if exit_info.kind == "ok":
            slot.proc = None                  # drained cleanly
            slot.next_spawn = None
            return
        # A death while holding a valid lease implicates the task --
        # unless the supervisor itself killed the worker for a stalled
        # heartbeat (the lease was already requeued; the task is
        # innocent).
        if not slot.self_killed:
            for tid, lease in q.leases().items():
                if lease.get("owner") == slot.owner:
                    implicate(tid, slot.owner, exit_info.kind)
        slot.proc = None
        if slot.restarts >= max_restarts:
            slot.abandoned = True
            emit("abandon", f"worker:{slot.idx}",
                 restarts=slot.restarts)
            return
        slot.restarts += 1
        report["restarts"] += 1
        counters["restarts"].inc()
        delay = backoff_delay(slot.restarts - 1, restart_base_s,
                              restart_max_s)
        slot.next_spawn = now + delay
        emit("restart", f"worker:{slot.idx}", attempt=slot.restarts,
             delay_s=round(delay, 3), cause=exit_info.kind)

    with span("elastic sweep", lanes=n, workers=n_workers):
        try:
            cover = covering_spans(q.done().values(), n)
            while cover is None:
                now = time.time()
                if deadline is not None and time.monotonic() > deadline:
                    raise RuntimeError(
                        f"run_elastic: timed out after {timeout} s with "
                        f"incomplete coverage; state left in {work_dir}")
                for slot in slots:
                    if slot.proc is not None and \
                            slot.proc.poll() is not None:
                        handle_exit(slot, time.monotonic())
                    if slot.proc is None and not slot.abandoned and \
                            slot.next_spawn is not None and \
                            time.monotonic() >= slot.next_spawn:
                        spawn(slot)
                scan_leases(now)
                note_done()
                cover = covering_spans(q.done().values(), n)
                if cover is not None:
                    break
                if all(s.proc is None and (s.abandoned or
                                           s.next_spawn is None)
                       for s in slots):
                    tails = {s.idx: stderr_tail(os.path.join(
                        work_dir, f"worker_{s.idx}.stderr.log"))
                        for s in slots}
                    kinds = [f"worker {e['worker']}: {e['kind']} "
                             f"({e['detail']})"
                             for e in report["exits"][-n_workers:]]
                    raise RuntimeError(
                        "run_elastic: every worker slot is dead or "
                        "abandoned with coverage incomplete; last "
                        "exits: " + "; ".join(kinds) +
                        f"; stderr tails: {tails}; state left in "
                        f"{work_dir}")
                time.sleep(poll_s)
        finally:
            q.request_stop()
            for slot in slots:
                if slot.proc is not None and slot.proc.poll() is None:
                    slot.proc.terminate()
            grace = time.monotonic() + 5.0
            for slot in slots:
                if slot.proc is None:
                    continue
                while slot.proc.poll() is None and \
                        time.monotonic() < grace:
                    time.sleep(0.05)
                if slot.proc.poll() is None:
                    slot.proc.kill()
                    slot.proc.wait()

        note_done()

        # Merge in lane order. Quarantined spans degrade to per-lane
        # salvage rows (same keys/dtypes as real results); overlapped
        # prefixes from parent/child duplicates are sliced off.
        parts = []
        cur = 0
        for a, b, rec in cover:
            lo = max(a, cur)
            if rec.get("status") == "quarantined":
                arrs = salvage_arrays(sim.spec, b - lo,
                                      tof_mask=(tof_terms or None),
                                      check_stability=check_stability)
                # Unlike a salvaged chunk (lanes merely unsolved),
                # these lanes were actively quarantined by the poison
                # ladder -- mark them so forensics lists them.
                arrs["quarantined"][:] = True
            else:
                from ..utils.io import load_results
                arrs = load_results(q.result_path(rec["tid"]))
                if lo > a:
                    arrs = {k: v[lo - a:] for k, v in arrs.items()}
            parts.append(arrs)
            cur = b
        out = {k: np.concatenate([p[k] for p in parts], axis=0)
               for k in parts[0].keys()}

    report["n_failed_lanes"] = int(
        np.sum(~np.asarray(out["success"], dtype=bool)))
    report["n_done"] = len(counted_done)
    report["work_dir"] = None if own_dir else work_dir
    if own_dir:
        import shutil
        shutil.rmtree(work_dir, ignore_errors=True)
    return out, report


# ---------------------------------------------------------------------
# The coalescer's elastic runner and the chaos drill.

def packed_group_runner(work_dir: Optional[str] = None,
                        n_workers: int = 2, tof_terms=None,
                        device=None, **elastic_opts):
    """Build the scheduler-integrated runner for
    :class:`..parallel.dispatch.SweepCoalescer`: coalesced groups feed
    the elastic tier instead of bypassing it.

    - K > 1 groups (one ABI bucket by construction) run as one packed
      in-process sweep on ``device`` -- packing is the scheduling
      decision for them.
    - K = 1 groups whose tenant is a full ``System`` run through
      :func:`run_elastic` (``abi=True``, so the answer is the solo
      ``sweep_steady_state(..., abi=True)``) in a per-group subdirectory
      of ``work_dir``, with ``tof_terms`` forwarded (a mask cannot ride
      to a subprocess; a K = 1 group that only has a mask array runs
      in-process).

    Both paths append their lifecycle to ``work_dir`` events
    (run_elastic writes its own ``events.jsonl`` per group dir; the
    coalescer's ``pack-flush`` event lands in the shared one)."""

    def run(sims, conds_list, masks, x0s, *, check_stability, opts,
            pos_jac_tol):
        from ..parallel.batch import packed_sweep_steady_state
        from ..solvers.newton import SolverOptions
        solver_opts = SolverOptions() if opts is None else opts
        if (len(sims) == 1 and work_dir is not None
                and hasattr(sims[0], "spec") and x0s[0] is None
                and (masks[0] is None or tof_terms is not None)):
            import tempfile
            os.makedirs(work_dir, exist_ok=True)
            group_dir = tempfile.mkdtemp(prefix="packgroup_",
                                         dir=work_dir)
            opts_ = dict(elastic_opts)
            opts_.setdefault("abi", True)
            out, _report = run_elastic(
                sims[0], conds_list[0], n_workers=n_workers,
                work_dir=group_dir, tof_terms=tof_terms,
                check_stability=check_stability, device=device, **opts_)
            return [out]
        return packed_sweep_steady_state(
            [getattr(s, "spec", s) for s in sims], conds_list,
            tof_mask=masks, x0=x0s, opts=solver_opts,
            check_stability=check_stability, pos_jac_tol=pos_jac_tol,
            device=device)

    return run


def chaos_drill(n_lanes: int = 8, chunk: int = 2, n_workers: int = 2,
                verbose: bool = False, device=None) -> dict:
    """Run a small elastic sweep with one worker crash injected through
    the workers' fault plan, and fail loudly on any lost lane.

    Returns ``{"ok": bool, "restarts": ..., "n_failed_lanes": ...,
    "quarantined": [...], "leases": {...}, "wall_s": ...}``. ``device``:
    the workers' device (None: the CUDA card)."""
    import tempfile

    from ..models.synthetic import synthetic_system
    from ..parallel.batch import broadcast_conditions

    sim = synthetic_system(n_species=8, n_reactions=10, seed=0,
                           device=device)
    conds = broadcast_conditions(sim.conditions(), n_lanes)
    conds = conds._replace(T=np.linspace(450.0, 650.0, n_lanes))
    with tempfile.TemporaryDirectory(prefix="pycatkin_chaos_") as td:
        plan = {"specs": [{"site": "worker:0", "kind": "worker-crash",
                           "times": 1}],
                "state_dir": os.path.join(td, "faultstate")}
        t0 = time.monotonic()
        out, report = run_elastic(
            sim, conds, n_workers=n_workers, chunk=chunk,
            work_dir=os.path.join(td, "work"), fault_plan=plan,
            device=device, ttl_s=6.0, heartbeat_s=0.5, max_kills=3,
            restart_base_s=0.2, restart_max_s=1.0, timeout=600.0)
        wall = time.monotonic() - t0
    lost = int(np.sum(~np.asarray(out["success"], dtype=bool)))
    ok = (lost == 0 and not report["quarantined"]
          and report["restarts"] >= 1)
    result = {"ok": bool(ok), "restarts": report["restarts"],
              "n_failed_lanes": lost,
              "quarantined": report["quarantined"],
              "leases": report["leases"], "wall_s": round(wall, 2)}
    if verbose:
        print(json.dumps(result, indent=2))
    return result


def _main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="elastic scheduler worker entry / chaos drill")
    ap.add_argument("cfg", nargs="?", help="worker config JSON path")
    ap.add_argument("--drill", action="store_true",
                    help="run the chaos drill and exit nonzero on "
                         "any lost lane")
    ap.add_argument("--device", default=None,
                    help="the drill's device (default: the CUDA card; "
                         "'cpu' for the CPU)")
    args = ap.parse_args(argv)
    if args.drill:
        result = chaos_drill(verbose=True, device=args.device)
        return 0 if result["ok"] else 1
    if not args.cfg:
        ap.error("worker config path required (or --drill)")
    _worker_main(args.cfg)
    return 0


if __name__ == "__main__":
    sys.exit(_main())
