"""The sweep dispatcher: worker processes over a split lane grid, the
elastic scheduler's front door and the request coalescer (port of
``pycatkin_tpu/parallel/dispatch.py``).

:func:`dispatch_sweep` runs one sweep in one of three modes:

- ``"static"`` (the default): the lane grid is cut into ``n_workers``
  contiguous blocks, each solved by a fresh ``python -m
  pycatkin_tpu_torch.parallel.dispatch <cfg>`` process (the mechanism
  through the loader's JSON, the block through ``.npz``), and the
  parent concatenates the blocks in lane order;
- ``"elastic"``: the lease-based elastic scheduler
  (:func:`..robustness.scheduler.run_elastic`);
- ``"packed"``: the multi-tenant front door --
  :class:`SweepCoalescer` groups pending sweep requests by ABI
  fingerprint, lane count, TOF-ness and ``x0``-ness (transients: by
  fingerprint, lane count and save grid) and flushes each group as one
  packed multi-tenant run (:func:`.batch.packed_sweep_steady_state` /
  :func:`.batch.packed_batch_transient`) on the coalescer's ``device``.

Workers run on the device the caller gives (None: the CUDA card; worker
``i`` takes card ``i`` modulo the machine's count), one CUDA context
each; they are started with ``subprocess``, never forked.
"""

from __future__ import annotations

import functools
import itertools
import json
import os
import subprocess
import sys
import threading
import time
from typing import Optional

import numpy as np

#: File name of the worker events log in a coalescer's ``work_dir``.
EVENTS = "events.jsonl"

_PACKED_MAX_OCCUPANCY_DEFAULT = 8
_PACKED_MAX_WAIT_DEFAULT = 0.05


def save_conditions(path: str, conds) -> None:
    """Write a (lane-batched) Conditions to ``.npz`` (the namedtuple's own
    field list, so a schema change round-trips automatically)."""
    np.savez_compressed(
        path, **{f: np.asarray(getattr(conds, f)) for f in conds._fields})


def load_conditions(path: str):
    """Read a Conditions written by :func:`save_conditions`."""
    from ..frontend.spec import Conditions
    with np.load(path) as z:
        return Conditions(**{f: z[f] for f in Conditions._fields})


class PackedRequest:
    """One tenant's pending sweep inside a :class:`SweepCoalescer` group.
    ``result()`` blocks nothing: if the group has not flushed yet it
    flushes now (the submitting caller asking for its answer is the
    strongest "stop waiting for co-tenants" signal).

    ``submitted_at`` / ``wait_budget_s`` record when the request arrived
    and how long it agreed to wait for co-tenants (None: the coalescer's
    ``max_wait_s``); the serving layer's SLA-aware flushing derives group
    deadlines from them. A non-None ``save_ts`` marks a transient
    request: its group key carries the save grid, and the group runs
    through the coalescer's ``transient_runner``."""

    __slots__ = ("sim", "spec", "conds", "tof_mask", "x0", "save_ts",
                 "group_key", "submitted_at", "wait_budget_s",
                 "_coalescer", "_result", "done")

    def __init__(self, coalescer, sim, spec, conds, tof_mask, x0,
                 group_key, submitted_at=None, wait_budget_s=None,
                 save_ts=None):
        self.sim = sim
        self.spec = spec
        self.conds = conds
        self.tof_mask = tof_mask
        self.x0 = x0
        self.save_ts = save_ts
        self.group_key = group_key
        self.submitted_at = submitted_at
        self.wait_budget_s = wait_budget_s
        self._coalescer = coalescer
        self._result = None
        self.done = False

    def result(self) -> dict:
        if not self.done:
            self._coalescer.flush_group(self.group_key)
        if not self.done:
            raise RuntimeError("packed request did not resolve after "
                               "its group flushed (coalescer bug)")
        return self._result


def _default_packed_runner(sims, conds_list, masks, x0s, *,
                           check_stability, opts, pos_jac_tol, device=None):
    """The coalescer's sweep runner: the in-process packed sweep on
    ``device``."""
    from ..solvers.newton import SolverOptions
    from .batch import packed_sweep_steady_state
    return packed_sweep_steady_state(
        [getattr(s, "spec", s) for s in sims], conds_list,
        tof_mask=masks, x0=x0s,
        opts=SolverOptions() if opts is None else opts,
        check_stability=check_stability, pos_jac_tol=pos_jac_tol,
        device=device)


def _default_transient_runner(sims, conds_list, save_ts, *, opts=None,
                              device=None):
    """The coalescer's transient runner: the in-process packed transient
    (:func:`.batch.packed_batch_transient`) on ``device``. Returns
    per-tenant dicts ``{ys, ok, quarantined}`` of tensors on the device;
    ``quarantined`` marks lanes with a non-finite endpoint."""
    import torch
    from ..solvers.ode import ODEOptions
    from .batch import packed_batch_transient
    outs = []
    for ys, ok in packed_batch_transient(
            [getattr(s, "spec", s) for s in sims], conds_list, save_ts,
            opts=ODEOptions() if opts is None else opts, device=device):
        finite = torch.all(torch.isfinite(ys[:, -1, :]), dim=-1)
        outs.append({"ys": ys, "ok": ok, "quarantined": ~finite})
    return outs


class SweepCoalescer:
    """Continuous-batching front door of the sweep service: pending sweep
    requests are grouped by ``(abi_fingerprint, lane count, TOF-ness,
    x0-ness)`` -- the compatibility predicate of
    :func:`..frontend.abi.pack_lowered` plus the lane shape -- and each
    group is flushed as one packed multi-tenant run when it reaches
    ``max_occupancy`` tenants or its oldest request has waited
    ``max_wait_s`` seconds (checked by :meth:`poll`), whichever comes
    first. Requests whose mechanism lowers into no ABI bucket get a
    unique key from a monotonic counter, so they never co-pack and run
    as solo sweeps.

    ``runner`` is the group-execution seam: any callable ``runner(sims,
    conds_list, masks, x0s, *, check_stability, opts, pos_jac_tol) ->
    list[dict]``; ``transient_runner(sims, conds_list, save_ts, *,
    opts)`` likewise for transient groups. The defaults run in process
    on ``device`` (None: the CUDA card; ``"cpu"`` for the CPU).

    When ``work_dir`` is given, every flush appends a ``pack-flush``
    worker event (tenants, occupancy, lanes, per-tenant quarantine
    counts) to ``work_dir/events.jsonl`` (:data:`EVENTS`).

    ``to_host=True`` moves each group's results to host numpy right
    after its runner, in one counted sync (``utils.profiling.host_sync``,
    label ``"coalescer flush"``): the serving layer's responses are built
    from them. Otherwise results stay tensors on the device.

    ``autoflush=False`` turns the coalescer into a pure queue for an
    external scheduler (the serving layer): ``submit`` never runs the
    solver inline; the owner polls :meth:`due_keys`, pops ripe groups
    with :meth:`take_group` (thread-safe: the queue state lives behind
    the coalescer's own lock) and executes them with
    :meth:`run_requests` wherever it likes. ``submit(...,
    wait_budget_s=...)`` tightens the group's flush deadline below
    ``max_wait_s`` per request: a group's deadline is the earliest
    budget of its members.

    The kernels' launch counters and the solvers' sync counters are
    process-wide (``ops.cuda_linalg.LAUNCHES``, ``solvers.newton.SYNCS``,
    ``solvers.ode.SYNCS``); they attribute to one group only while groups
    run one at a time, as the server runs them."""

    def __init__(self, runner=None, max_occupancy: Optional[int] = None,
                 max_wait_s: Optional[float] = None,
                 work_dir: Optional[str] = None,
                 check_stability: bool = False, opts=None,
                 pos_jac_tol: float = 1e-2, autoflush: bool = True,
                 transient_runner=None, ode_opts=None, device=None,
                 to_host: bool = False):
        if max_occupancy is None:
            max_occupancy = _PACKED_MAX_OCCUPANCY_DEFAULT
        if max_wait_s is None:
            max_wait_s = _PACKED_MAX_WAIT_DEFAULT
        if max_occupancy < 1:
            raise ValueError(f"max_occupancy must be >= 1, "
                             f"got {max_occupancy}")
        self.device = device
        self.to_host = bool(to_host)
        self.runner = (functools.partial(_default_packed_runner,
                                         device=device)
                       if runner is None else runner)
        self.transient_runner = (functools.partial(
            _default_transient_runner, device=device)
            if transient_runner is None else transient_runner)
        self.ode_opts = ode_opts
        self.max_occupancy = int(max_occupancy)
        self.max_wait_s = float(max_wait_s)
        self.work_dir = work_dir
        self.check_stability = bool(check_stability)
        self.opts = opts
        self.pos_jac_tol = float(pos_jac_tol)
        self.autoflush = bool(autoflush)
        # The queue dicts are shared between the serving loop's submit
        # path and its executor threads; the lock covers queue state
        # only -- no holder ever runs the solver or another locking
        # method, so there is no nesting and flushes happen outside it.
        self._lock = threading.Lock()
        self._groups: dict = {}      # guarded-by: _lock
        self._deadlines: dict = {}   # guarded-by: _lock
        # Monotonic solo-group sequence: ``id(sim)`` is reusable after
        # GC, so two distinct unfittable sims could alias one key.
        self._solo_seq = itertools.count()
        self.flushes = 0

    def _group_key(self, sim, spec, conds, tof_mask, x0, save_ts=None):
        n = len(np.asarray(conds.T))
        fp = None
        try:
            from ..frontend import abi as _abi
            low = (spec if isinstance(spec, _abi.AbiLowered)
                   else _abi.maybe_lower(spec))
            if low is not None:
                fp = low.abi_fingerprint
        except Exception:
            fp = None
        if fp is None:
            # Unpackable mechanism: unique key -> always a solo group.
            return ("solo", next(self._solo_seq), n)
        if save_ts is not None:
            # Transient groups carry the exact save grid: the packed
            # transient integrates ONE shared grid, so only same-grid
            # requests may co-pack (and never with steady sweeps).
            return (fp, n, "transient",
                    tuple(float(t) for t in save_ts))
        return (fp, n, tof_mask is not None, x0 is not None)

    def _deadline_for(self, reqs) -> float:
        """The group flush deadline its members imply: the earliest
        ``submitted_at + wait_budget_s`` (``max_wait_s`` for members
        without a budget)."""
        return min(r.submitted_at
                   + (self.max_wait_s if r.wait_budget_s is None
                      else float(r.wait_budget_s))
                   for r in reqs)

    def submit(self, sim, conds, tof_mask=None, x0=None,
               wait_budget_s: Optional[float] = None,
               save_ts=None) -> PackedRequest:
        """Queue one sweep; returns its :class:`PackedRequest` handle.
        With ``autoflush`` (the default) the group flushes inline when it
        reaches ``max_occupancy``. ``wait_budget_s`` caps how long this
        request may sit waiting for co-tenants. A non-None ``save_ts``
        queues a transient request instead: grouped by (fingerprint,
        lanes, grid), executed through ``transient_runner``."""
        spec = getattr(sim, "spec", sim)
        key = self._group_key(sim, spec, conds, tof_mask, x0, save_ts)
        req = PackedRequest(self, sim, spec, conds, tof_mask, x0, key,
                            submitted_at=time.monotonic(),
                            wait_budget_s=wait_budget_s,
                            save_ts=save_ts)
        with self._lock:
            group = self._groups.setdefault(key, [])
            group.append(req)
            self._deadlines[key] = min(
                self._deadlines.get(key, float("inf")),
                self._deadline_for([req]))
            should_flush = (self.autoflush
                            and len(group) >= self.max_occupancy)
        # Flush outside the lock: flush_group -> take_group re-acquires
        # it, and the runner must never execute under queue state.
        if should_flush:
            self.flush_group(key)
        return req

    @property
    def pending(self) -> int:
        with self._lock:
            return sum(len(g) for g in self._groups.values())

    def due_keys(self, now: Optional[float] = None) -> list:
        """Keys of every group ripe for flushing: at or over
        ``max_occupancy``, or past its deadline. A caller-supplied
        ``now`` earlier than every deadline -- a clock that moved
        backwards -- simply reports nothing due."""
        now = time.monotonic() if now is None else now
        with self._lock:
            due = [k for k, g in self._groups.items()
                   if len(g) >= self.max_occupancy]
            for key, d in self._deadlines.items():
                if now >= d and key not in due and key in self._groups:
                    due.append(key)
        return due

    def poll(self, now: Optional[float] = None) -> int:
        """Flush every group whose oldest request exceeded its wait
        budget; returns how many groups flushed."""
        now = time.monotonic() if now is None else now
        with self._lock:
            due = [k for k, d in self._deadlines.items()
                   if now >= d and self._groups.get(k)]
        for key in due:
            self.flush_group(key)
        return len(due)

    def flush_all(self) -> int:
        """Flush every pending group regardless of age or occupancy."""
        flushed = 0
        with self._lock:
            keys = list(self._groups)
        for key in keys:
            reqs = self.take_group(key)
            if reqs:
                self.run_requests(key, reqs)
                flushed += 1
        return flushed

    def take_group(self, key, limit: Optional[int] = None) -> list:
        """Pop up to ``limit`` (all, if None) requests of one group,
        leaving any remainder queued with a recomputed deadline. Mutates
        only the queue dicts under the coalescer's lock -- never runs the
        solver -- so an external scheduler may call it from any thread.
        Returns ``[]`` for a key already taken (the benign half of a
        flush race)."""
        with self._lock:
            reqs = self._groups.get(key)
            if not reqs:
                self._groups.pop(key, None)
                self._deadlines.pop(key, None)
                return []
            if limit is None or len(reqs) <= limit:
                self._groups.pop(key, None)
                self._deadlines.pop(key, None)
                return reqs
            taken, rest = reqs[:limit], reqs[limit:]
            self._groups[key] = rest
            self._deadlines[key] = self._deadline_for(rest)
            return taken

    def run_requests(self, key, reqs) -> list:
        """Execute one taken group through its runner now, resolve its
        requests and emit the pack-flush event; returns the per-tenant
        result dicts in request order."""
        if reqs and reqs[0].save_ts is not None:
            # Transient group (the grid is part of the group key).
            outs = self.transient_runner(
                [r.sim for r in reqs], [r.conds for r in reqs],
                reqs[0].save_ts, opts=self.ode_opts)
        else:
            outs = self.runner(
                [r.sim for r in reqs], [r.conds for r in reqs],
                [r.tof_mask for r in reqs], [r.x0 for r in reqs],
                check_stability=self.check_stability, opts=self.opts,
                pos_jac_tol=self.pos_jac_tol)
        if len(outs) != len(reqs):
            raise RuntimeError(
                f"coalescer runner returned {len(outs)} results for "
                f"{len(reqs)} tenants")
        if self.to_host:
            from ..utils.profiling import host_sync
            outs = host_sync(list(outs), "coalescer flush")
        for r, o in zip(reqs, outs):
            r._result = o
            r.done = True
        self.flushes += 1
        self._emit_flush(key, reqs, outs)
        return outs

    def flush_group(self, key) -> None:
        reqs = self.take_group(key)
        if reqs:
            self.run_requests(key, reqs)

    def _emit_flush(self, key, reqs, outs) -> None:
        from ..utils.profiling import record_event
        k = len(reqs)
        kb = 1 << max(0, (k - 1).bit_length())
        n = len(np.asarray(reqs[0].conds.T))
        tq = _quarantined_counts(outs)
        fields = {"tenants": k, "k_bucket": kb,
                  "pack_occupancy": k / kb, "lanes": n,
                  "tenant_quarantined": tq}
        label = key[0] if isinstance(key, tuple) else str(key)
        record_event("worker", action="pack-flush", label=str(label),
                     **fields)
        if self.work_dir:
            from ..utils.io import append_json_line
            os.makedirs(self.work_dir, exist_ok=True)
            append_json_line(
                os.path.join(self.work_dir, EVENTS),
                {"kind": "worker", "action": "pack-flush",
                 "label": str(label), "t": time.time(), **fields})


def _quarantined_counts(outs) -> list:
    """Quarantined lanes of each tenant's result; tensors are summed on
    their device and pulled together."""
    qs = [o.get("quarantined") if isinstance(o, dict) else None
          for o in outs]
    on_dev = [i for i, q in enumerate(qs)
              if q is not None and not isinstance(q, np.ndarray)
              and hasattr(q, "device")]
    counts = [0 if q is None or i in on_dev else int(np.asarray(q).sum())
              for i, q in enumerate(qs)]
    if on_dev:
        import torch
        sums = torch.stack([qs[i].sum() for i in on_dev]).tolist()
        for i, n in zip(on_dev, sums):
            counts[i] = int(n)
    return counts


def _split_slices(n: int, k: int):
    """k contiguous, near-equal [start, stop) blocks covering range(n)."""
    bounds = np.linspace(0, n, k + 1).astype(int)
    return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])
            if b > a]


def host_conditions(conds):
    """``conds`` with every field a numpy array (tensors read on the
    host)."""
    return type(conds)(*(v.detach().cpu().numpy() if hasattr(v, "detach")
                         else np.asarray(v) for v in conds))


def dispatch_sweep(sim, conds, n_workers: Optional[int] = None,
                   work_dir: Optional[str] = None,
                   tof_terms=None, check_stability: bool = False,
                   worker_env: Optional[dict] = None,
                   timeout: Optional[float] = None,
                   on_failure: Optional[str] = None,
                   mode: str = "static", device=None, abi: bool = False,
                   fault_plan=None, **elastic_opts):
    """Run ``sweep_steady_state`` over ``conds`` (the JAX package's
    ``dispatch_sweep``).

    ``mode="static"`` (default): ``n_workers`` (default 2) independent
    worker processes, one contiguous block of lanes each; returns the
    merged result dict (host numpy, lane order preserved, each block
    bit for bit an in-process sweep of that block). ``timeout`` is one
    shared deadline for the whole sweep. ``on_failure``: ``"raise"``
    (default; inputs and partial results stay in ``work_dir``) or
    ``"salvage"`` (each failed or timed-out block is re-solved in the
    parent, with a ``host-fallback`` degradation event; only a failed
    re-solve raises). ``worker_env`` adds environment variables to the
    workers'; ``fault_plan`` (a fault plan's JSON form) is installed in
    every worker, whose ``dispatch:block:<i>`` site it can target.

    ``mode="elastic"``: :func:`..robustness.scheduler.run_elastic`
    (dead or stalled workers restarted, leases stolen, poison spans
    bisected to quarantine); extra keyword arguments (``chunk``,
    ``ttl_s``, ``max_kills``, ...) pass through, ``on_failure`` does
    not apply. Returns the merged result dict.

    ``mode="packed"``: ``sim`` and ``conds`` are per-tenant sequences (a
    single value is shared); the requests are coalesced by
    :class:`SweepCoalescer` into same-bucket packs on ``device`` and
    each pack runs as one packed sweep; returns a list of per-tenant
    result dicts, each its tenant's solo ``sweep_steady_state(...,
    abi=True)``. Extra keyword arguments (``max_occupancy``,
    ``max_wait_s``, ``runner``, ``opts``, ``pos_jac_tol``) configure the
    coalescer; the worker options (``n_workers``, ``worker_env``,
    ``timeout``, ``on_failure``) do not apply, and passing one raises
    ``TypeError``.

    ``device`` (None: the CUDA card) and ``abi`` go to every worker's
    sweep. The JAX package's ``aot_cache`` is not taken: the port has no
    AOT executable cache (ROADMAP.md Queue A item 12f)."""
    if mode not in ("static", "elastic", "packed"):
        raise ValueError(f"mode must be 'static', 'elastic' or "
                         f"'packed', got {mode!r}")
    if mode == "packed":
        worker_opts = dict(n_workers=n_workers, worker_env=worker_env,
                           timeout=timeout, on_failure=on_failure,
                           fault_plan=fault_plan)
        given = sorted(k for k, v in worker_opts.items() if v is not None)
        if given:
            raise TypeError(f"packed mode runs in-process; {given} do(es) "
                            f"not apply")
        return _packed_dispatch(sim, conds, work_dir, tof_terms,
                                check_stability, device, elastic_opts)
    n_workers = 2 if n_workers is None else int(n_workers)
    if mode == "elastic":
        from ..robustness.scheduler import run_elastic
        out, _report = run_elastic(
            sim, conds, n_workers=n_workers, work_dir=work_dir,
            tof_terms=tof_terms, check_stability=check_stability,
            worker_env=worker_env, timeout=timeout, device=device,
            abi=abi, fault_plan=fault_plan, **elastic_opts)
        return out
    if elastic_opts:
        raise TypeError(f"unexpected keyword argument(s) for static "
                        f"mode: {sorted(elastic_opts)}")
    on_failure = "raise" if on_failure is None else on_failure
    if on_failure not in ("raise", "salvage"):
        raise ValueError(f"on_failure must be 'raise' or 'salvage', "
                         f"got {on_failure!r}")
    return _static_dispatch(sim, host_conditions(conds), n_workers,
                            work_dir, tof_terms, check_stability,
                            worker_env, timeout, on_failure, device, abi,
                            fault_plan)


def _packed_dispatch(sim, conds, work_dir, tof_terms, check_stability,
                     device, coalescer_opts) -> list:
    sims = list(sim) if isinstance(sim, (list, tuple)) else [sim]
    conds_list = (list(conds) if isinstance(conds, list)
                  else [conds] * len(sims))
    if len(conds_list) != len(sims):
        raise ValueError(f"packed mode: {len(conds_list)} conds "
                         f"for {len(sims)} sims")
    masks = [None] * len(sims)
    if tof_terms:
        from .. import engine
        masks = [engine.tof_mask_for(getattr(s, "spec", s),
                                     list(tof_terms))
                 for s in sims]
    co = SweepCoalescer(work_dir=work_dir, check_stability=check_stability,
                        device=device, **coalescer_opts)
    reqs = [co.submit(s, c, tof_mask=m)
            for s, c, m in zip(sims, conds_list, masks)]
    co.flush_all()
    return [r.result() for r in reqs]


def _static_dispatch(sim, conds, n_workers, work_dir, tof_terms,
                     check_stability, worker_env, timeout, on_failure,
                     device, abi, fault_plan) -> dict:
    import tempfile

    from ..robustness.scheduler import _PACKAGE_PARENT
    from ..utils.io import save_system_json

    own_dir = work_dir is None
    if own_dir:
        work_dir = tempfile.mkdtemp(prefix="pycatkin_dispatch_")
    os.makedirs(work_dir, exist_ok=True)
    model_path = os.path.join(work_dir, "model.json")
    save_system_json(sim, model_path)

    n = len(conds.T)
    blocks = _split_slices(n, n_workers)
    procs = []
    for i, (a, b) in enumerate(blocks):
        in_path = os.path.join(work_dir, f"block_{i}.npz")
        out_path = os.path.join(work_dir, f"result_{i}.npz")
        save_conditions(in_path, type(conds)(*(v[a:b] for v in conds)))
        cfg = {"model": model_path, "conds": in_path, "out": out_path,
               "block": i,
               "tof_terms": list(tof_terms) if tof_terms else None,
               "check_stability": bool(check_stability),
               "device": None if device is None else str(device),
               "abi": bool(abi), "faults": fault_plan}
        cfg_path = os.path.join(work_dir, f"job_{i}.json")
        with open(cfg_path, "w") as f:
            json.dump(cfg, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_PARENT, env.get("PYTHONPATH")) if p)
        if worker_env:
            env.update({k: str(v) for k, v in worker_env.items()})
        # Per-block stderr logs, so a failure can quote the traceback.
        stderr_path = os.path.join(work_dir, f"worker_{i}.stderr.log")
        with open(stderr_path, "wb") as errf:
            procs.append((i, out_path, subprocess.Popen(
                [sys.executable, "-m",
                 "pycatkin_tpu_torch.parallel.dispatch", cfg_path],
                env=env, cwd=os.getcwd(), stderr=errf)))

    failed = []
    deadline = (time.monotonic() + timeout) if timeout else None
    try:
        for i, out_path, p in procs:
            try:
                remaining = (max(0.0, deadline - time.monotonic())
                             if deadline is not None else None)
                rc = p.wait(timeout=remaining)
            except subprocess.TimeoutExpired:
                failed.append((i, None, True))
                continue
            if rc != 0 or not os.path.exists(out_path):
                failed.append((i, rc, False))
    finally:
        # Never orphan workers: on timeout/failure/interrupt, kill
        # whatever is still running before propagating.
        for _, _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if failed and on_failure == "salvage":
        # The host-fallback rung at the dispatch tier: the block inputs
        # are still on disk, so the parent re-solves them itself.
        from ..obs import metrics as _metrics
        from ..utils.profiling import record_event
        still_failed = []
        for i, rc, timed_out in failed:
            cfg_path = os.path.join(work_dir, f"job_{i}.json")
            record_event("degradation", label=f"dispatch:block:{i}",
                         rung="host-fallback",
                         detail="worker process failed/timed out; "
                                "re-solving block in-process")
            _metrics.counter("pycatkin_dispatch_salvaged_blocks_total",
                             "worker blocks re-solved in-process").inc()
            try:
                _worker(cfg_path, inject_faults=False)
            except Exception as exc:  # noqa: BLE001 - reported below
                record_event("degradation", label=f"dispatch:block:{i}",
                             rung="abandoned",
                             detail=f"in-process re-solve failed: {exc}")
                _metrics.counter(
                    "pycatkin_dispatch_abandoned_blocks_total",
                    "worker blocks abandoned after salvage failed").inc()
                still_failed.append((i, rc, timed_out))
        failed = still_failed
    if failed:
        from ..robustness.scheduler import stderr_tail
        from ..utils.retry import classify_worker_exit
        details = []
        for i, rc, timed_out in failed:
            info = classify_worker_exit(rc, timed_out=timed_out)
            line = f"block {i}: {info.kind} ({info.detail})"
            tail = stderr_tail(
                os.path.join(work_dir, f"worker_{i}.stderr.log"))
            if tail:
                line += "; last stderr: " + " | ".join(tail[-3:])
            details.append(line)
        raise RuntimeError(
            "dispatch_sweep: worker block(s) failed or timed out -- "
            + "; ".join(details)
            + f"; inputs and any partial results are in {work_dir}")

    from ..utils.profiling import span
    merged: dict = {}
    with span("dispatch merge", n_blocks=len(procs)):
        for i, out_path, _ in procs:
            with np.load(out_path) as z:
                for key in z.files:
                    merged.setdefault(key, []).append(z[key])
        out = {k: np.concatenate(v, axis=0) for k, v in merged.items()}
    if own_dir:
        # Self-created scratch only; a caller's work_dir (and any
        # failure, which raises above) is left in place.
        import shutil
        shutil.rmtree(work_dir, ignore_errors=True)
    return out


def _worker(cfg_path: str, inject_faults: bool = True) -> None:
    """One static-mode block: load the mechanism and the block, sweep,
    write the results. With ``inject_faults`` (a worker process) the
    config's fault plan is installed and the ``dispatch:block:<i>`` site
    fires first; the parent's in-process salvage passes False -- an
    injected fault models the worker, and the salvage is another."""
    from contextlib import nullcontext

    from .. import engine
    from ..frontend.loader import read_from_input_file
    from ..robustness import faults
    from ..robustness.scheduler import _worker_device
    from ..utils.profiling import host_sync, span
    from .batch import sweep_steady_state

    with open(cfg_path) as f:
        cfg = json.load(f)
    block = cfg.get("block", 0)
    scope = (faults.fault_scope(faults.FaultPlan.from_json(cfg.get("faults")))
             if inject_faults else nullcontext())
    with scope:
        if inject_faults:
            faults.inject(f"dispatch:block:{block}")
        device = _worker_device(cfg.get("device"), block)
        sim = read_from_input_file(cfg["model"], device=device)
        conds = load_conditions(cfg["conds"])
        mask = (engine.tof_mask_for(sim.spec, cfg["tof_terms"])
                if cfg.get("tof_terms") else None)
        with span("worker sweep", block=block):
            out = sweep_steady_state(
                sim.spec, conds, tof_mask=mask,
                check_stability=cfg.get("check_stability", False),
                abi=bool(cfg.get("abi", False)), device=device)
        np.savez_compressed(cfg["out"],
                            **host_sync(out, "worker block results"))


if __name__ == "__main__":
    _worker(sys.argv[1])
