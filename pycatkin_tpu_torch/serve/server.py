"""The sweep server: one asyncio process owning the queue and the card
(port of ``pycatkin_tpu/serve/server.py``).

Request lifecycle:

  accept -> lower -> coalesce -> flush -> respond

``accept`` is admission control: a bounded pending queue with structured
rejects (overloaded / draining), and the ``serve:accept`` fault-injection
site. ``lower`` builds the System from the wire mechanism (on the
server's device) and lane-stacks the conditions grid. ``coalesce``
submits to a :class:`..parallel.dispatch.SweepCoalescer` in
``autoflush=False`` mode with the request's deadline-class wait budget: a
group flushes when full or when its most impatient member's budget
burns. ``flush`` is the scheduler loop: due groups are taken on the event
loop and executed one at a time on a worker thread (the
``serve:flush:<label>`` site, then the packed run on the server's device
and one counted sync of its results), so the process-wide kernel launch
and sync counters attribute to one group at a time. ``respond`` ships
each tenant's slice with the run manifest, lane telemetry and
quarantine report.

The solver never runs on the event loop and the event loop never waits
on the solver; backpressure is the bounded queue, not TCP. The port
compiles no program per shape: ``pycatkin_compile_total`` counts the
CUDA kernel library's builds and loads (the first use in a process),
which :meth:`SweepServer.start` does on a card before it listens (and
:meth:`SweepServer.warm` before traffic), so
``zero_compile_rate_after_warm`` and ``flushes_with_compiles`` still
measure flushes that paid a build or a load. ``stats()["launches"]``
counts the kernels this process launched since :meth:`SweepServer.start`,
so that a fleet's replicas report their own launches.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from typing import Optional

import numpy as np

from ..obs import metrics as _metrics
from ..utils.profiling import record_event
from .protocol import (E_BAD_REQUEST, E_DRAINING, E_INTERNAL,
                       E_OVERLOADED, LINE_LIMIT, PROTOCOL, ServeConfig,
                       ServeError,
                       error_response, jsonable, parse_sweep_request,
                       parse_transient_request)

# Lane-shaped result keys returned by default; the full solution
# vector ``y`` rides only on request (``"return": ["y"]``) -- at
# bucket 512 it is the whole response payload.
SUMMARY_KEYS = ("success", "residual", "attempts", "quarantined",
                "stable", "tof", "activity")


def _compile_counts() -> dict:
    """``pycatkin_compile_total`` by kind: the kernel library's builds
    (``"build"``) and loads (``"load"``)."""
    vals = _metrics.counter("pycatkin_compile_total").values()
    return {kind: float(vals.get(f'kind="{kind}"', 0.0))
            for kind in ("build", "load")}


def _compile_count() -> float:
    """Kernel library builds and loads so far -- the marginal-compile
    probe the flush loop differences."""
    return sum(_compile_counts().values())


def _key_label(key) -> str:
    """Group-key display label: the ABI fingerprint for packable
    groups, ``"solo"`` for the unfittable."""
    return str(key[0]) if isinstance(key, tuple) and key else str(key)


class SweepServer:
    """A live sweep service; see module docstring for the lifecycle.

    Construct with a :class:`serve.protocol.ServeConfig` (or field
    overrides), ``await start()``, submit through
    :class:`serve.client.SweepClient` / TCP, ``await drain()`` to
    finish every accepted request and shut down."""

    def __init__(self, config: Optional[ServeConfig] = None, **overrides):
        self.config = config or ServeConfig(**overrides)
        self._coalescer = None
        self._own_work_dir = None
        self._futures: dict = {}
        self._taken = 0
        self._admitted = 0
        self._inflight = 0
        self._draining = False
        self._stopping = False
        self._wake: Optional[asyncio.Event] = None
        self._scheduler_task = None
        self._tcp_server = None
        self._writers: set = set()
        self.port: Optional[int] = None
        self.boot_manifest: dict = {}
        self.flushes = 0
        self.flushes_with_compiles = 0
        self.compiles_total = 0.0
        self._occupancy_sum = 0.0
        self._requests_total = 0
        self._rejected_total = 0
        self._completed_total = 0
        self._warm_marked = False
        self.flushes_after_warm = 0
        self.flushes_with_compiles_after_warm = 0
        self.compiles_after_warm = 0.0
        self._launches0: dict = {}

    # -- boot ----------------------------------------------------------

    def _make_coalescer(self):
        """The coalescer; with ``runner="elastic"`` its solo groups run
        through the elastic scheduler
        (:func:`..robustness.scheduler.packed_group_runner`), in
        ``work_dir`` or a directory of the server's own."""
        from ..parallel.dispatch import SweepCoalescer
        cfg = self.config
        work_dir = cfg.work_dir
        runner = None
        if cfg.runner == "elastic":
            from ..robustness.scheduler import packed_group_runner
            if work_dir is None:
                import tempfile
                self._own_work_dir = tempfile.mkdtemp(
                    prefix="pycatkin_serve_")
                work_dir = self._own_work_dir
            runner = packed_group_runner(work_dir=work_dir,
                                         n_workers=cfg.n_workers,
                                         device=cfg.device)
        return SweepCoalescer(runner=runner, autoflush=False,
                              work_dir=work_dir,
                              max_occupancy=cfg.max_occupancy,
                              max_wait_s=cfg.max_wait_s, device=cfg.device,
                              to_host=True)

    async def start(self, listen: bool = True) -> "SweepServer":
        """Resolve the device (raises without a CUDA card unless the
        config says ``device="cpu"``), load the CUDA kernel library on a
        card (the counterpart of the JAX server's AOT pack import; raises
        :class:`..ops.cuda_linalg.KernelError` when it does not build or
        load), note the launch counters (:meth:`launches` counts from
        here), compute the boot manifest, start the scheduler loop and
        (optionally) the TCP listener."""
        from ..ops import cuda_linalg
        from ..parallel.batch import resolve_device
        dev = resolve_device(self.config.device)
        self._launches0 = dict(cuda_linalg.LAUNCHES_BY_SHAPE)
        if dev.type == "cuda":
            c0 = _compile_counts()
            await asyncio.to_thread(cuda_linalg.load)
            c1 = _compile_counts()
            record_event("serve", action="kernels-loaded",
                         compiled=c1["build"] - c0["build"],
                         loaded=c1["load"] - c0["load"])
        self._coalescer = self._make_coalescer()
        self._wake = asyncio.Event()
        from ..obs.manifest import run_manifest
        self.boot_manifest = await asyncio.to_thread(
            run_manifest, device=self.config.device)
        self._scheduler_task = asyncio.create_task(
            self._scheduler_loop())
        if listen:
            self._tcp_server = await asyncio.start_server(
                self._on_connection, self.config.host, self.config.port,
                limit=LINE_LIMIT)
            self.port = self._tcp_server.sockets[0].getsockname()[1]
            record_event("serve", action="listen",
                         host=self.config.host, port=self.port)
        return self

    def warm(self, sims, lanes: int, k_buckets=(2, 4, 8),
             transient_save_ts=None) -> dict:
        """Build or load the CUDA kernels (on a card), then run what the
        serve path dispatches for these representative mechanisms at
        this lane count: one solo sweep (the K = 1 flush) and one packed
        sweep per ``k_bucket`` of each mechanism, and, given a save grid
        ``transient_save_ts``, one solo and one packed transient per
        ``k_bucket`` from its first save time over one initial step
        (``ODEOptions().h0``): a step's shapes are the whole grid's, and
        the grid only sets how many steps run, which for a stiff
        mechanism is thousands. Blocking -- call before serving traffic
        (or through ``asyncio.to_thread``). Returns the kernel library's
        ``compiled`` (built) and ``loaded`` counts of this call."""
        from ..parallel.batch import (batch_transient, broadcast_conditions,
                                      packed_batch_transient,
                                      packed_sweep_steady_state,
                                      resolve_device, sweep_steady_state)
        c0 = _compile_counts()
        dev = resolve_device(self.config.device)
        if dev.type == "cuda":
            from ..ops import cuda_linalg
            cuda_linalg.load()
        ks = [k for k in k_buckets if k >= 2]
        for sim in sims:
            spec = getattr(sim, "spec", sim)
            conds = broadcast_conditions(sim.conditions(), lanes)
            sweep_steady_state(spec, conds, abi=True, device=dev)
            for k in ks:
                packed_sweep_steady_state([spec] * k, [conds] * k,
                                          device=dev)
            if transient_save_ts is not None:
                from ..solvers.ode import ODEOptions
                t0 = float(list(transient_save_ts)[0])
                ts = [t0, t0 + ODEOptions().h0]
                batch_transient(spec, conds, ts, abi=True, device=dev)
                for k in ks:
                    packed_batch_transient([spec] * k, [conds] * k, ts,
                                           device=dev)
        c1 = _compile_counts()
        compiled = c1["build"] - c0["build"]
        loaded = c1["load"] - c0["load"]
        record_event("serve", action="warm", compiled=compiled,
                     loaded=loaded, lanes=lanes)
        return {"compiled": compiled, "loaded": loaded}

    def mark_warm(self) -> None:
        """Declare warmup over: flush and compile counters accumulated
        after this call feed the zero-compile-rate gate."""
        self._warm_marked = True
        self.flushes_after_warm = 0
        self.flushes_with_compiles_after_warm = 0
        self.compiles_after_warm = 0.0

    # -- shutdown ------------------------------------------------------

    async def drain(self) -> None:
        """Stop admitting, finish every accepted request, then stop.
        The no-loss path: rejects are structured responses, accepted
        requests always resolve."""
        if self._draining:
            await self.wait_stopped()
            return
        self._draining = True
        record_event("serve", action="drain-begin",
                     pending=self._coalescer.pending)
        # ``_admitted`` covers the window between admission and the
        # coalescer submit (mechanism/conditions still building on a
        # worker thread): such requests are accepted but not yet
        # visible in any queue, and drain must wait for them too.
        while (self._coalescer.pending or self._taken
               or self._futures or self._admitted or self._inflight):
            self._wake.set()
            await asyncio.sleep(self.config.tick_s)
        record_event("serve", action="drain-complete",
                     completed=self._completed_total)
        await self.stop()

    async def stop(self) -> None:
        """Tear down listener and scheduler. Pending requests (if any)
        are failed; prefer :meth:`drain` for a graceful exit."""
        self._stopping = True
        if self._wake is not None:
            self._wake.set()
        if self._scheduler_task is not None:
            try:
                await self._scheduler_task
            finally:
                self._scheduler_task = None
        if self._tcp_server is not None:
            self._tcp_server.close()
            # Server.wait_closed waits for every open connection (Python
            # 3.12), so the connections are closed here: every accepted
            # request has been answered by now (drain) or failed below.
            for w in list(self._writers):
                w.close()
            await self._tcp_server.wait_closed()
            self._tcp_server = None
        for req, fut in list(self._futures.items()):
            if not fut.done():
                fut.set_exception(ServeError(
                    E_INTERNAL, "server stopped before flush"))
            self._futures.pop(req, None)
        if self._own_work_dir:
            import shutil
            shutil.rmtree(self._own_work_dir, ignore_errors=True)
            self._own_work_dir = None

    async def wait_stopped(self) -> None:
        while self._scheduler_task is not None or self._tcp_server:
            await asyncio.sleep(self.config.tick_s)

    @property
    def draining(self) -> bool:
        return self._draining

    # -- request handling ---------------------------------------------

    async def handle(self, payload) -> dict:
        """Process one request object; returns the response object.
        Shared by the TCP framing and the in-process client -- every
        failure maps to a structured error response here."""
        req_id = payload.get("id") if isinstance(payload, dict) else None
        try:
            if not isinstance(payload, dict):
                raise ServeError(E_BAD_REQUEST,
                                 "expected a JSON object per line")
            op = payload.get("op", "sweep")
            if op == "ping":
                return {"protocol": PROTOCOL, "id": req_id, "ok": True,
                        "pong": True, "draining": self._draining}
            if op == "stats":
                return {"protocol": PROTOCOL, "id": req_id, "ok": True,
                        "stats": self.stats()}
            if op == "drain":
                asyncio.get_running_loop().create_task(self.drain())
                return {"protocol": PROTOCOL, "id": req_id, "ok": True,
                        "draining": True}
            if op == "sweep":
                return await self._handle_sweep(payload, req_id)
            if op == "transient":
                return await self._handle_transient(payload, req_id)
            raise ServeError(E_BAD_REQUEST, f"unknown op {op!r}")
        except ServeError as exc:
            self._rejected_total += 1
            _metrics.counter("pycatkin_serve_rejects_total",
                             "serve requests rejected").inc(
                                 code=exc.code)
            record_event("serve", action="reject", label=str(exc.code),
                         detail=str(exc))
            return error_response(req_id, exc.code, str(exc))
        except Exception as exc:  # noqa: BLE001 - wire boundary
            self._rejected_total += 1
            _metrics.counter("pycatkin_serve_rejects_total",
                             "serve requests rejected").inc(
                                 code=E_INTERNAL)
            return error_response(req_id, E_INTERNAL,
                                  f"{type(exc).__name__}: {exc}")

    async def _handle_sweep(self, payload: dict, req_id) -> dict:
        from ..robustness import faults
        t0 = time.monotonic()
        self._requests_total += 1
        _metrics.counter("pycatkin_serve_requests_total",
                         "sweep requests admitted or rejected").inc()
        parsed = parse_sweep_request(payload)
        if self._draining:
            raise ServeError(E_DRAINING,
                             "server is draining; no new sweeps")
        if self.pending >= self.config.max_pending:
            raise ServeError(
                E_OVERLOADED,
                f"pending queue is full ({self.pending} >= "
                f"{self.config.max_pending}); retry with backoff")
        faults.inject("serve:accept")
        self._admitted += 1
        try:
            sim = await asyncio.to_thread(self._build_system,
                                          parsed["mechanism"])
            conds = await asyncio.to_thread(self._build_conds, sim,
                                            parsed["T"], parsed["p"])
            mask = None
            if parsed["tof_terms"]:
                from .. import engine
                mask = await asyncio.to_thread(engine.tof_mask_for,
                                               sim.spec,
                                               parsed["tof_terms"])
            wait = parsed["wait_budget_s"]
            if wait is None:
                wait = self.config.wait_budget_for(
                    parsed["deadline_class"])
            fut = asyncio.get_running_loop().create_future()
            req = self._coalescer.submit(sim, conds, tof_mask=mask,
                                         wait_budget_s=wait)
            self._futures[req] = fut
            if self._stopping:
                # The scheduler is gone; nothing will ever flush this.
                self._futures.pop(req, None)
                raise ServeError(E_DRAINING,
                                 "server stopped during admission")
            _metrics.gauge("pycatkin_serve_queue_depth",
                           "sweep requests queued, unflushed").set(
                               float(self._coalescer.pending))
            self._wake.set()
            out, pack = await fut
        finally:
            self._admitted -= 1
        total_s = time.monotonic() - t0
        _metrics.histogram("pycatkin_serve_request_seconds",
                           "accepted sweep request wall time").observe(
                               total_s,
                               deadline_class=parsed["deadline_class"])
        self._completed_total += 1
        return self._sweep_response(req_id, sim, out, pack, parsed,
                                    total_s)

    def _sweep_response(self, req_id, sim, out: dict, pack: dict,
                        parsed: dict, total_s: float) -> dict:
        result = {k: out[k] for k in SUMMARY_KEYS if k in out}
        for key in parsed["want"]:
            if key in out:
                result[key] = out[key]
        q = np.asarray(out.get("quarantined", ()), dtype=bool)
        manifest = dict(self.boot_manifest)
        manifest["abi"] = {
            "fingerprint": (pack.get("abi_fingerprint")),
            "packed": pack.get("tenants", 1) > 1}
        solve_s = pack.get("solve_s", 0.0)
        return {
            "protocol": PROTOCOL, "id": req_id, "ok": True,
            "lanes": len(parsed["T"]),
            "result": jsonable(result),
            "quarantine": {"count": int(q.sum()),
                           "lanes": np.nonzero(q)[0].tolist()},
            "lane_telemetry": jsonable(out.get("lane_telemetry")),
            "manifest": jsonable(manifest),
            "pack": jsonable({k: v for k, v in pack.items()
                              if k != "solve_s"}),
            "timing": {"total_s": total_s, "solve_s": solve_s,
                       "queue_s": max(0.0, total_s - solve_s)},
        }

    async def _handle_transient(self, payload: dict, req_id) -> dict:
        from ..robustness import faults
        t0 = time.monotonic()
        self._requests_total += 1
        _metrics.counter("pycatkin_serve_requests_total",
                         "sweep requests admitted or rejected").inc()
        parsed = parse_transient_request(payload)
        if self._draining:
            raise ServeError(E_DRAINING,
                             "server is draining; no new sweeps")
        if self.pending >= self.config.max_pending:
            raise ServeError(
                E_OVERLOADED,
                f"pending queue is full ({self.pending} >= "
                f"{self.config.max_pending}); retry with backoff")
        faults.inject("serve:accept")
        self._admitted += 1
        try:
            sim = await asyncio.to_thread(self._build_system,
                                          parsed["mechanism"])
            conds = await asyncio.to_thread(self._build_conds, sim,
                                            parsed["T"], parsed["p"])
            wait = parsed["wait_budget_s"]
            if wait is None:
                wait = self.config.wait_budget_for(
                    parsed["deadline_class"])
            fut = asyncio.get_running_loop().create_future()
            req = self._coalescer.submit(sim, conds,
                                         wait_budget_s=wait,
                                         save_ts=parsed["save_ts"])
            self._futures[req] = fut
            if self._stopping:
                # The scheduler is gone; nothing will ever flush this.
                self._futures.pop(req, None)
                raise ServeError(E_DRAINING,
                                 "server stopped during admission")
            _metrics.gauge("pycatkin_serve_queue_depth",
                           "sweep requests queued, unflushed").set(
                               float(self._coalescer.pending))
            self._wake.set()
            out, pack = await fut
        finally:
            self._admitted -= 1
        total_s = time.monotonic() - t0
        _metrics.histogram("pycatkin_serve_request_seconds",
                           "accepted sweep request wall time").observe(
                               total_s,
                               deadline_class=parsed["deadline_class"])
        self._completed_total += 1
        return self._transient_response(req_id, out, pack, parsed,
                                        total_s)

    def _transient_response(self, req_id, out: dict, pack: dict,
                            parsed: dict, total_s: float) -> dict:
        ys = np.asarray(out["ys"])
        result = {"ok": np.asarray(out["ok"]),
                  "endpoint": ys[:, -1, :]}
        if "ys" in parsed["want"]:
            result["ys"] = ys
        for key in parsed["want"]:
            if key != "ys" and key in out:
                result[key] = out[key]
        q = np.asarray(out.get("quarantined", ()), dtype=bool)
        manifest = dict(self.boot_manifest)
        manifest["abi"] = {
            "fingerprint": (pack.get("abi_fingerprint")),
            "packed": pack.get("tenants", 1) > 1}
        solve_s = pack.get("solve_s", 0.0)
        return {
            "protocol": PROTOCOL, "id": req_id, "ok": True,
            "lanes": len(parsed["T"]),
            "save_points": len(parsed["save_ts"]),
            "result": jsonable(result),
            "quarantine": {"count": int(q.sum()),
                           "lanes": np.nonzero(q)[0].tolist()},
            "lane_telemetry": jsonable(out.get("lane_telemetry")),
            "manifest": jsonable(manifest),
            "pack": jsonable({k: v for k, v in pack.items()
                              if k != "solve_s"}),
            "timing": {"total_s": total_s, "solve_s": solve_s,
                       "queue_s": max(0.0, total_s - solve_s)},
        }

    def _build_system(self, mech):
        if hasattr(mech, "conditions") and hasattr(mech, "spec"):
            return mech  # in-process client handed a built System
        if not isinstance(mech, dict):
            raise ServeError(E_BAD_REQUEST,
                             "/mechanism: expected reference-schema "
                             "JSON object (or a built System in-proc)")
        import tempfile
        from ..frontend.loader import read_from_input_file
        with tempfile.TemporaryDirectory(
                prefix="pycatkin_serve_mech_") as td:
            path = os.path.join(td, "mechanism.json")
            with open(path, "w") as fh:
                json.dump(mech, fh)
            try:
                return read_from_input_file(path,
                                            device=self.config.device)
            except ServeError:
                raise
            except Exception as exc:  # noqa: BLE001 - schema boundary
                raise ServeError(E_BAD_REQUEST,
                                 f"/mechanism: {exc}") from None

    def _build_conds(self, sim, T, p):
        from ..parallel.batch import stack_conditions
        return stack_conditions([sim.conditions(T=t, p=pv)
                                 for t, pv in zip(T, p)])

    # -- scheduler loop ------------------------------------------------

    @property
    def pending(self) -> int:
        """Admitted-but-unresolved request count (queued + in flush)."""
        return (self._coalescer.pending if self._coalescer else 0) \
            + self._taken

    @property
    def in_service(self) -> int:
        """Sweeps past admission whose response has not been built yet
        (building, queued, solving, or resolving)."""
        return self._admitted

    async def _scheduler_loop(self):
        co = self._coalescer
        while True:
            if self._stopping:
                return
            due = (list(co._groups) if self._draining
                   else co.due_keys())
            for key in due:
                reqs = co.take_group(key, limit=co.max_occupancy)
                if reqs:
                    await self._run_group(key, reqs)
            _metrics.gauge("pycatkin_serve_queue_depth",
                           "sweep requests queued, unflushed").set(
                               float(co.pending))
            if self._stopping:
                return
            try:
                await asyncio.wait_for(self._wake.wait(),
                                       timeout=self.config.tick_s)
            except asyncio.TimeoutError:
                pass
            self._wake.clear()

    async def _run_group(self, key, reqs):
        label = _key_label(key)
        self._taken += len(reqs)
        c0 = _compile_count()
        t0 = time.monotonic()
        try:
            outs = await asyncio.to_thread(self._execute_group, label,
                                           key, reqs)
        except Exception as exc:  # noqa: BLE001 - reported per request
            record_event("serve", action="flush-failed", label=label,
                         detail=f"{type(exc).__name__}: {exc}")
            err = ServeError(E_INTERNAL,
                             f"group flush failed: {exc}")
            for r in reqs:
                fut = self._futures.pop(r, None)
                if fut is not None and not fut.done():
                    fut.set_exception(err)
            return
        finally:
            self._taken -= len(reqs)
        solve_s = time.monotonic() - t0
        compiles = _compile_count() - c0
        k = len(reqs)
        kb = 1 << max(0, (k - 1).bit_length())
        self.flushes += 1
        self.compiles_total += compiles
        self._occupancy_sum += k / kb
        if compiles:
            self.flushes_with_compiles += 1
        if self._warm_marked:
            self.flushes_after_warm += 1
            self.compiles_after_warm += compiles
            if compiles:
                self.flushes_with_compiles_after_warm += 1
        solo = isinstance(key, tuple) and key and key[0] == "solo"
        _metrics.counter("pycatkin_serve_flush_groups_total",
                         "coalesced groups flushed by the server").inc(
                             kind="solo" if solo else "packed")
        if compiles:
            _metrics.counter(
                "pycatkin_serve_flush_compiles_total",
                "kernel library builds charged to serve flushes").inc(compiles)
        pack = {"tenants": k, "k_bucket": kb, "occupancy": k / kb,
                "abi_fingerprint": None if solo else label,
                "compiles": compiles, "flush_seq": self.flushes,
                "solve_s": solve_s}
        for r, o in zip(reqs, outs):
            fut = self._futures.pop(r, None)
            if fut is not None and not fut.done():
                fut.set_result((o, pack))

    def _execute_group(self, label: str, key, reqs):
        """One group on the worker thread: the flush fault site, then the
        packed run on the server's device and one counted sync of the
        tenants' results (the coalescer's ``to_host``). Groups run one at
        a time (the scheduler loop awaits each), which keeps the
        process-wide launch and sync counters attributable."""
        from ..robustness import faults
        faults.inject(f"serve:flush:{label}")
        return self._coalescer.run_requests(key, reqs)

    # -- introspection -------------------------------------------------

    def launches(self) -> list:
        """Kernel launches of this process since :meth:`start`, as sorted
        ``[name, n, lanes, count]`` rows (float32 names end ``_f32``);
        none on the CPU, where the wrappers run their plain versions."""
        from ..ops import cuda_linalg
        rows = []
        for key, c in cuda_linalg.LAUNCHES_BY_SHAPE.items():
            c -= self._launches0.get(key, 0)
            if c > 0:
                rows.append([*key, c])
        return sorted(rows)

    def stats(self) -> dict:
        co = self._coalescer
        return {
            "protocol": PROTOCOL,
            "draining": self._draining,
            "port": self.port,
            "pending": self.pending,
            "queued": co.pending if co else 0,
            "requests_total": self._requests_total,
            "completed_total": self._completed_total,
            "rejected_total": self._rejected_total,
            "flushes": self.flushes,
            "flushes_with_compiles": self.flushes_with_compiles,
            "compiles_total": self.compiles_total,
            "launches": self.launches(),
            "mean_occupancy": (self._occupancy_sum / self.flushes
                               if self.flushes else None),
            "flushes_after_warm": self.flushes_after_warm,
            "flushes_with_compiles_after_warm":
                self.flushes_with_compiles_after_warm,
            "compiles_after_warm": self.compiles_after_warm,
            "zero_compile_rate_after_warm": (
                1.0 - (self.flushes_with_compiles_after_warm
                       / self.flushes_after_warm)
                if self.flushes_after_warm else None),
        }

    # -- TCP framing ---------------------------------------------------

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter):
        wlock = asyncio.Lock()
        tasks = set()
        self._writers.add(writer)

        async def one_line(line: bytes):
            self._inflight += 1
            try:
                try:
                    payload = json.loads(line)
                except ValueError as exc:
                    resp = error_response(None, E_BAD_REQUEST,
                                          f"invalid JSON: {exc}")
                else:
                    resp = await self.handle(payload)
                data = (json.dumps(resp) + "\n").encode()
                async with wlock:
                    writer.write(data)
                    await writer.drain()
            except (ConnectionError, asyncio.CancelledError):
                pass
            finally:
                self._inflight -= 1

        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                if not line.strip():
                    continue
                t = asyncio.get_running_loop().create_task(
                    one_line(line))
                tasks.add(t)
                t.add_done_callback(tasks.discard)
            if tasks:
                await asyncio.gather(*tasks, return_exceptions=True)
        finally:
            self._writers.discard(writer)
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass
