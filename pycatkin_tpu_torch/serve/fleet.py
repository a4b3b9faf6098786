"""Replica fleet supervision for the serving layer (port of
``pycatkin_tpu/serve/fleet.py``).

One :class:`.server.SweepServer` process is one failure domain; the
fleet tier's job is to keep N of them alive and honest so the front
router (:mod:`.router`) always has somewhere to send traffic. A
:class:`ReplicaSupervisor` spawns N ``python -m pycatkin_tpu_torch.serve``
subprocesses (on the card unless ``FleetConfig.command`` says
otherwise) and, per replica:

- **warm boot before registration** -- a replica on the card loads the
  CUDA kernel library inside ``start()`` before it prints its
  ``{"serving": true, "port": ...}`` line (the port's counterpart of
  the JAX package's AOT pack import: it compiles no programs), and
  exits nonzero when the library does not build or load; the
  supervisor registers a replica only after scraping that line and
  winning a first ``ping``, so a replica is never routable before its
  kernels are loaded;
- **exit classification** via ``utils/retry.classify_worker_exit``:
  signal deaths are preemption-shaped and restart on the shared
  full-jitter backoff curve (``utils/retry.backoff_delay``), nonzero
  exits are program-shaped and restart on the slow lane (the full
  restart cap, no jitter) so a crash-looping replica cannot hot-spin;
- **bounded restarts** -- ``max_restarts`` exceeded abandons the
  replica (the router routes around it; the drill gates on
  availability, not on immortality);
- **liveness probes** -- periodic ``ping`` over a fresh connection;
  ``ping_misses`` consecutive misses demote the replica (unroutable,
  announced to listeners), twice that kills it outright, which is how
  a SIGSTOP-stalled replica (the ``replica-stall`` chaos kind) comes
  back: stall -> missed pings -> demote -> kill -> classified signal
  death -> backoff -> warm reboot.

Chaos: each monitor tick polls :func:`..robustness.faults.take` at its
``router:replica:<i>`` site for the externally-enacted serve-tier
kinds and enacts what fires (``replica-crash`` = SIGKILL,
``replica-stall`` = SIGSTOP). ``times=N`` budgets hold fleet-wide
through the plan's O_EXCL ticket files.

Router supervision (``FleetConfig(role="router")``): the same
machinery keeps the front router alive -- one supervised
``python -m pycatkin_tpu_torch.serve --router`` subprocess under the same
backoff/abandon/registration policy, polled at the ``router:front``
chaos site for the ``router-crash`` kind (SIGKILL). The parent
publishes its replica endpoints to an atomically-written JSON file
(``FleetConfig.endpoints_file``, tmp + ``os.replace``) that the router
subprocess consumes through :class:`FileFleet`; a rebooted router
re-reads the file, replays its request journal (:mod:`.durable`) and
rebinds the same fixed port so clients reconnect.

The port reads no environment variable: ``FleetConfig``'s None fields
take the JAX package's defaults (3 replicas, 1 router, 5 restarts, a
ping every 0.5 s, 3 misses to demote).
"""

from __future__ import annotations

import asyncio
import json
import os
import signal
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

from ..obs import metrics as _metrics
from ..utils.profiling import record_event
from ..utils.retry import backoff_delay, classify_worker_exit

# The serve-tier chaos kinds THIS tier enacts (the router enacts the
# connection-level ones at its dispatch sites). A role="router"
# supervisor polls for the router-death kind instead.
SUPERVISOR_FAULT_KINDS = ("replica-crash", "replica-stall")
ROUTER_SUPERVISOR_FAULT_KINDS = ("router-crash",)

_STDERR_TAIL_LINES = 40

_PACKAGE_PARENT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@dataclass
class FleetConfig:
    """Settings of one supervised replica fleet. ``None`` fields take
    the defaults at construction (see the module docstring)."""

    n_replicas: Optional[int] = None
    command: Optional[list] = None     # argv override (test stubs)
    env: dict = field(default_factory=dict)   # added to the children's env
    max_restarts: Optional[int] = None
    restart_base_delay_s: float = 0.05
    restart_max_delay_s: float = 2.0
    ping_period_s: Optional[float] = None
    ping_misses: Optional[int] = None
    ping_timeout_s: float = 2.0
    boot_timeout_s: float = 120.0
    stop_grace_s: float = 30.0
    tick_s: float = 0.02
    host: str = "127.0.0.1"
    # "replica" supervises SweepServer subprocesses; "router"
    # supervises one front-router subprocess (router-crash drills).
    role: str = "replica"
    # Atomic endpoints-file publication for an out-of-process router
    # (consumed via FileFleet); None disables.
    endpoints_file: Optional[str] = None

    def __post_init__(self):
        if self.role not in ("replica", "router"):
            raise ValueError(f"role must be 'replica' or 'router', "
                             f"got {self.role!r}")
        if self.n_replicas is None:
            # One front router per fleet: a second would race for the
            # same fixed port.
            self.n_replicas = 1 if self.role == "router" else 3
        if self.max_restarts is None:
            self.max_restarts = 5
        if self.ping_period_s is None:
            self.ping_period_s = 0.5
        if self.ping_misses is None:
            self.ping_misses = 3
        if self.n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, "
                             f"got {self.n_replicas}")


class Replica:
    """One supervised server slot: the slot index is stable identity,
    the incarnation counts boots (each restart is a new subprocess on
    a new port)."""

    def __init__(self, idx: int):
        self.idx = idx
        self.incarnation = 0
        self.proc = None
        self.port: Optional[int] = None
        self.state = "dead"     # booting | up | demoted | dead | abandoned
        self.restarts = 0
        self.missed_pings = 0
        self.next_ping = 0.0
        self.stderr_tail: deque = deque(maxlen=_STDERR_TAIL_LINES)
        self._stderr_task = None

    @property
    def routable(self) -> bool:
        return self.state == "up"

    def summary(self) -> dict:
        return {"idx": self.idx, "state": self.state,
                "incarnation": self.incarnation, "port": self.port,
                "restarts": self.restarts,
                "missed_pings": self.missed_pings}


class ReplicaSupervisor:
    """Spawn, probe, demote, restart and retire N sweep-server
    replicas; see the module docstring for the lifecycle."""

    def __init__(self, config: Optional[FleetConfig] = None,
                 **overrides):
        self.config = config or FleetConfig(**overrides)
        self.replicas = [Replica(i)
                         for i in range(self.config.n_replicas)]
        self._listeners: list = []
        self._tasks: list = []
        self._stopping = False

    # -- lifecycle -----------------------------------------------------

    async def start(self) -> "ReplicaSupervisor":
        """Launch one monitor task per replica and wait until every
        replica registered (or was abandoned); raises if NONE came up."""
        for r in self.replicas:
            self._tasks.append(asyncio.get_running_loop().create_task(
                self._monitor(r)))
        await self.wait_ready()
        return self

    async def wait_ready(self, timeout_s: Optional[float] = None):
        deadline = time.monotonic() + (timeout_s if timeout_s
                                       is not None
                                       else self.config.boot_timeout_s)
        while any(r.state in ("dead", "booting") for r in self.replicas):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"fleet boot timed out: "
                    f"{[r.summary() for r in self.replicas]}")
            await asyncio.sleep(self.config.tick_s)
        if not any(r.routable for r in self.replicas):
            raise RuntimeError(
                f"no replica came up: "
                f"{[r.summary() for r in self.replicas]}")

    async def stop(self):
        """SIGTERM every replica (graceful drain path), escalate to
        SIGKILL after the grace window, and retire the monitors."""
        self._stopping = True
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            try:
                await t
            except asyncio.CancelledError:
                pass
        self._tasks = []
        procs = [(r, r.proc) for r in self.replicas
                 if r.proc is not None and r.proc.returncode is None]
        for r, proc in procs:
            try:
                proc.terminate()
            except ProcessLookupError:
                pass
        for r, proc in procs:
            try:
                await asyncio.wait_for(proc.wait(),
                                       self.config.stop_grace_s)
            except asyncio.TimeoutError:
                try:
                    proc.kill()
                except ProcessLookupError:
                    pass
                await proc.wait()
            r.state = "dead"
        for r in self.replicas:
            if r._stderr_task is not None:
                r._stderr_task.cancel()
                try:
                    await r._stderr_task
                except asyncio.CancelledError:
                    pass
                r._stderr_task = None
        self._set_up_gauge()

    # -- listeners (the router subscribes) -----------------------------

    def add_listener(self, fn) -> None:
        """``fn(event_dict)`` is called on every routability change:
        ``{"event": "up" | "down" | "abandoned", "idx", "incarnation",
        "host", "port"}``. Callbacks run on the event loop and must
        not block."""
        self._listeners.append(fn)

    def _notify(self, event: str, r: Replica) -> None:
        self._set_up_gauge()
        self._publish_endpoints()
        info = {"event": event, "idx": r.idx,
                "incarnation": r.incarnation, "host": self.config.host,
                "port": r.port}
        for fn in list(self._listeners):
            fn(dict(info))

    def _publish_endpoints(self) -> None:
        """Republish the routable set to ``endpoints_file`` (tmp +
        ``os.replace``, so an out-of-process FileFleet reader never
        sees a half-written file)."""
        path = self.config.endpoints_file
        if not path:
            return
        tmp = f"{path}.tmp"
        with open(tmp, "w") as fh:
            json.dump({"endpoints": self.endpoints()}, fh)
        os.replace(tmp, path)

    def _set_up_gauge(self) -> None:
        _metrics.gauge("pycatkin_router_replicas_up",
                       "routable replicas in the supervised fleet").set(
                           float(sum(r.routable
                                     for r in self.replicas)))

    def endpoints(self) -> list:
        """Routable ``(idx, incarnation, host, port)`` snapshots."""
        return [{"idx": r.idx, "incarnation": r.incarnation,
                 "host": self.config.host, "port": r.port}
                for r in self.replicas if r.routable]

    def stats(self) -> dict:
        return {"n_replicas": self.config.n_replicas,
                "up": sum(r.routable for r in self.replicas),
                "replicas": [r.summary() for r in self.replicas]}

    # -- monitor loop --------------------------------------------------

    async def _monitor(self, r: Replica):
        from ..robustness import faults
        cfg = self.config
        while not self._stopping:
            if r.state == "abandoned":
                return
            if r.proc is None:
                if r.restarts > cfg.max_restarts:
                    r.state = "abandoned"
                    record_event("router", action="replica-abandoned",
                                 replica=r.idx, restarts=r.restarts)
                    self._notify("abandoned", r)
                    return
                await self._spawn(r)
                continue
            if self.config.role == "router":
                site = "router:front"
                kinds = ROUTER_SUPERVISOR_FAULT_KINDS
            else:
                site = f"router:replica:{r.idx}"
                kinds = SUPERVISOR_FAULT_KINDS
            for spec in faults.take(site, kinds=kinds):
                self._enact(r, spec.kind, site)
            if r.proc.returncode is not None:
                await self._handle_exit(r)
                continue
            now = time.monotonic()
            if now >= r.next_ping and r.state in ("up", "demoted"):
                r.next_ping = now + cfg.ping_period_s
                await self._probe(r)
            await asyncio.sleep(cfg.tick_s)

    def _enact(self, r: Replica, kind: str, site: str) -> None:
        """Enact one externally-enacted chaos kind on a live child."""
        if r.proc is None or r.proc.returncode is not None:
            return
        record_event("router", action="chaos-enact", replica=r.idx,
                     label=site, fault_kind=kind)
        try:
            if kind in ("replica-crash", "router-crash"):
                r.proc.kill()                       # SIGKILL, no drain
            elif kind == "replica-stall":
                r.proc.send_signal(signal.SIGSTOP)  # alive, silent
        except ProcessLookupError:
            pass

    # -- spawn + registration ------------------------------------------

    def _command(self) -> list:
        if self.config.command:
            return list(self.config.command)
        if self.config.role == "router":
            # A supervised router must sit on a fixed port so clients
            # reconnect to the same address across incarnations; pass
            # an explicit command (with --port and --fleet-file) rather
            # than relying on this ephemeral-port default.
            return [sys.executable, "-m", "pycatkin_tpu_torch.serve",
                    "--router", "--host", self.config.host,
                    "--port", "0"]
        return [sys.executable, "-m", "pycatkin_tpu_torch.serve",
                "--host", self.config.host, "--port", "0"]

    async def _spawn(self, r: Replica):
        cfg = self.config
        if r.restarts > 0:
            we_kind = getattr(r, "last_exit_kind", "signal-death")
            if we_kind == "nonzero-exit":
                # Program-shaped exit: slow lane, no jitter -- a
                # deterministic crash loop must not hot-spin.
                delay = cfg.restart_max_delay_s
            else:
                delay = backoff_delay(r.restarts - 1,
                                      cfg.restart_base_delay_s,
                                      cfg.restart_max_delay_s)
            await asyncio.sleep(delay)
        r.incarnation += 1
        r.state = "booting"
        r.missed_pings = 0
        r.stderr_tail = deque(maxlen=_STDERR_TAIL_LINES)
        env = dict(os.environ)
        env.update(cfg.env)
        # The children import this package from wherever the parent
        # found it, whatever their working directory.
        env["PYTHONPATH"] = os.pathsep.join(
            p for p in (_PACKAGE_PARENT, env.get("PYTHONPATH")) if p)
        try:
            r.proc = await asyncio.create_subprocess_exec(
                *self._command(), env=env,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE)
        except OSError as exc:
            record_event("router", action="replica-spawn-failed",
                         replica=r.idx, detail=str(exc))
            r.proc = None
            r.restarts += 1
            r.state = "dead"
            return
        r._stderr_task = asyncio.get_running_loop().create_task(
            self._drain_stderr(r, r.proc.stderr))
        ok = await self._register(r)
        if ok:
            r.state = "up"
            r.next_ping = time.monotonic() + cfg.ping_period_s
            record_event("router", action="replica-up", replica=r.idx,
                         incarnation=r.incarnation, port=r.port)
            self._notify("up", r)
        elif r.proc is not None and r.proc.returncode is None:
            # Booted wrong (no serving line / failed first ping):
            # treat as a failed incarnation.
            try:
                r.proc.kill()
            except ProcessLookupError:
                pass
            await self._handle_exit(r)

    async def _register(self, r: Replica) -> bool:
        """Scrape the replica's ``serving`` line (printed only after
        its kernel library load and listen) and win one first ping."""
        try:
            async def scrape():
                while True:
                    line = await r.proc.stdout.readline()
                    if not line:
                        return None
                    try:
                        msg = json.loads(line)
                    except ValueError:
                        continue
                    if isinstance(msg, dict) and msg.get("serving"):
                        return int(msg["port"])
            port = await asyncio.wait_for(scrape(),
                                          self.config.boot_timeout_s)
        except (asyncio.TimeoutError, OSError, ValueError, KeyError):
            return False
        if port is None:
            return False
        r.port = port
        return await self._ping_once(r)

    async def _drain_stderr(self, r: Replica, stream):
        try:
            while True:
                line = await stream.readline()
                if not line:
                    return
                r.stderr_tail.append(
                    line.decode("utf-8", "replace").rstrip())
        except (asyncio.CancelledError, OSError):
            raise

    # -- probes + exits ------------------------------------------------

    async def _ping_once(self, r: Replica) -> bool:
        cfg = self.config
        writer = None
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(cfg.host, r.port),
                cfg.ping_timeout_s)
            writer.write(b'{"op": "ping", "id": "probe"}\n')
            await writer.drain()
            line = await asyncio.wait_for(reader.readline(),
                                          cfg.ping_timeout_s)
            resp = json.loads(line) if line.strip() else None
            return bool(isinstance(resp, dict) and resp.get("ok"))
        except (OSError, ValueError, asyncio.TimeoutError):
            return False
        finally:
            if writer is not None:
                writer.close()

    async def _probe(self, r: Replica):
        ok = await self._ping_once(r)
        if ok:
            r.missed_pings = 0
            if r.state == "demoted":
                r.state = "up"
                record_event("router", action="replica-promoted",
                             replica=r.idx)
                self._notify("up", r)
            return
        r.missed_pings += 1
        if r.state == "up" and \
                r.missed_pings >= self.config.ping_misses:
            r.state = "demoted"
            record_event("router", action="replica-demoted",
                         replica=r.idx, missed=r.missed_pings)
            self._notify("down", r)
        if r.missed_pings >= 2 * self.config.ping_misses:
            # Stalled beyond recovery (e.g. SIGSTOP): kill it so the
            # exit branch reboots a fresh incarnation.
            try:
                r.proc.kill()
            except (ProcessLookupError, AttributeError):
                pass

    async def _handle_exit(self, r: Replica):
        await r.proc.wait()
        we = classify_worker_exit(r.proc.returncode)
        r.last_exit_kind = we.kind
        was_routable = r.routable
        tail = list(r.stderr_tail)[-5:]
        record_event("router", action="replica-exit", replica=r.idx,
                     incarnation=r.incarnation, exit_kind=we.kind,
                     transient=we.transient, detail=we.detail,
                     stderr_tail=tail)
        _metrics.counter(
            "pycatkin_router_replica_restarts_total",
            "replica exits observed by the fleet supervisor").inc(
                kind=we.kind)
        if r._stderr_task is not None:
            r._stderr_task.cancel()
            try:
                await r._stderr_task
            except asyncio.CancelledError:
                pass
            r._stderr_task = None
        r.proc = None
        r.port = None
        r.restarts += 1
        r.state = "dead"
        if was_routable:
            self._notify("down", r)


class FileFleet:
    """The supervisor surface a :class:`.router.SweepRouter`
    consumes (``endpoints()`` / ``stats()`` / ``add_listener``),
    backed by the endpoints file a ReplicaSupervisor in ANOTHER
    process publishes (``FleetConfig.endpoints_file``). This is how a
    supervised router subprocess routes to replicas owned by its
    parent: the parent republishes atomically on every routability
    change, and incarnation bumps in the file retire stale links in
    the router's ``_link_for``. Listeners never fire -- cross-process
    routability changes surface through the file (and through link
    failures), not callbacks."""

    def __init__(self, path: str):
        self.path = str(path)
        self._sig = None
        self._cache: list = []

    def add_listener(self, fn) -> None:
        pass   # see the class docstring: the file IS the event stream

    def endpoints(self) -> list:
        try:
            st = os.stat(self.path)
        except OSError:
            return []
        sig = (st.st_mtime_ns, st.st_size)
        if sig != self._sig:
            try:
                with open(self.path) as fh:
                    data = json.load(fh)
            except (OSError, ValueError):
                # Mid-replace race or unreadable file: keep the last
                # good snapshot; the next call re-reads.
                return [dict(ep) for ep in self._cache]
            self._cache = list(data.get("endpoints", []))
            self._sig = sig
        return [dict(ep) for ep in self._cache]

    def stats(self) -> dict:
        eps = self.endpoints()
        return {"n_replicas": len(eps), "up": len(eps),
                "replicas": [], "endpoints_file": self.path}
