"""The front router: one wire endpoint multiplexing a replica fleet (port
of ``pycatkin_tpu/serve/router.py``).

Speaks the same ``pycatkin-serve/v1`` line protocol as a single
:class:`.server.SweepServer` -- clients cannot tell the difference --
and holds no tensor: mechanisms and results pass through verbatim (only
the request ``id`` is rewritten per dispatch), so the router process
never touches a device, and its event loop only ever moves bytes.

Per request:

- **admission control** -- ``E_DRAINING`` while draining,
  ``E_OVERLOADED`` when the router-wide in-flight cap is hit or every
  replica breaker is open;
- **deadline-class SLA budget** -- the request's end-to-end budget
  (``protocol.request_timeout_for``) bounds everything below; burning
  it yields a structured ``E_TIMEOUT``;
- **per-replica circuit breakers** -- consecutive dispatch failures
  open a breaker (closed -> open); after a cooldown the router probes
  the replica with a ``ping`` (open -> half-open) and closes on
  success, so a recovered replica re-enters rotation without eating
  live traffic first;
- **retries with full-jitter backoff** under the remaining budget
  (``utils/retry.backoff_delay``; the retryable-vs-fatal split is the
  shared taxonomy of ``utils/retry.TRANSIENT_CONNECTION_TYPES``),
  failing over to a different replica when one exists;
- **hedged dispatch** for the ``interactive`` class: a second replica
  is engaged once the primary is slower than the tracked latency
  quantile; the first answer wins and the loser is cancelled;
- **loss-free failover** -- a dead/partitioned replica's in-flight
  dispatches fail over idempotently (same-width sweeps are
  deterministic, so a duplicated dispatch is bit-identical); answers
  from abandoned dispatches that arrive late are suppressed and
  AUDITED: the duplicate must be bitwise identical to the answer the
  client saw, and a mismatch is a hard drill failure.

Chaos: each dispatch polls :func:`..robustness.faults.take` at its
``router:dispatch:<i>`` site for the connection-level kinds and enacts
them itself (``conn-reset`` aborts the replica link, ``torn-line``
truncates the dispatch's wire line mid-object). A fault plan reaches the
router as an active :func:`..robustness.faults.fault_scope` (in a
router process: JSON on its command line), never from the environment.

Durability: with a journal directory (``RouterConfig.journal_dir``),
sweeps carrying an ``idempotency_key`` are write-ahead journaled
(:mod:`.durable`):
the ``accepted`` record is fsynced before the ack line reaches the
socket, the answer is journaled before the client can see it, boot
replays the journal and re-dispatches the accepted-but-unanswered
backlog, and duplicate keys are answered bitwise from the journal.
Keyless requests take the legacy path untouched.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import time
from collections import deque
from dataclasses import dataclass
from typing import Optional

from ..obs import metrics as _metrics
from ..utils.profiling import record_event
from ..utils.retry import backoff_delay, is_transient_backend_error
from .durable import RequestJournal
from .protocol import (DEFAULT_REPLAY_CONCURRENCY, E_BAD_REQUEST,
                       E_DRAINING, E_INTERNAL, E_OVERLOADED, E_TIMEOUT,
                       E_UNKNOWN_KEY, LINE_LIMIT, PROTOCOL, ServeError,
                       accepted_ack, canonical_answer, error_response,
                       request_timeout_for, request_timeouts)

# The serve-tier chaos kinds THIS tier enacts at dispatch sites.
ROUTER_FAULT_KINDS = ("conn-reset", "torn-line")

# Replica error codes that mean "try another replica", not "tell the
# client": a draining or momentarily saturated replica is the fleet's
# problem, the fleet has spares.
_FAILOVER_CODES = frozenset({E_DRAINING, E_OVERLOADED})


@dataclass
class RouterConfig:
    """Settings of one front router. ``None`` fields take the JAX
    package's defaults at construction (the port reads no environment
    variable): ``max_inflight`` 64, ``breaker_fails`` 3,
    ``breaker_cooldown_s`` 1.0, ``hedge_quantile`` 0.95, ``hedge_min_s``
    0.05, ``retries`` 3, ``replay_concurrency`` 4, ``segment_bytes``
    1 MiB, ``timeouts`` the per-class request timeouts of
    :func:`.protocol.request_timeouts`, updated by the mapping given."""

    host: str = "127.0.0.1"
    port: int = 0
    max_inflight: Optional[int] = None
    breaker_fails: Optional[int] = None
    breaker_cooldown_s: Optional[float] = None
    hedge_quantile: Optional[float] = None
    hedge_min_s: Optional[float] = None
    retries: Optional[int] = None
    retry_base_delay_s: float = 0.02
    retry_max_delay_s: float = 0.5
    connect_timeout_s: float = 2.0
    probe_timeout_s: float = 2.0
    tick_s: float = 0.02
    # Durability: a journal directory enables the write-ahead request
    # journal; None leaves the router memory-only with byte-identical
    # keyless behaviour.
    journal_dir: Optional[str] = None
    replay_concurrency: Optional[int] = None
    segment_bytes: Optional[int] = None
    # Per-class end-to-end request budgets over the defaults, e.g.
    # {"interactive": 120.0}; resolved to the full table.
    timeouts: Optional[dict] = None

    def __post_init__(self):
        if self.max_inflight is None:
            self.max_inflight = 64
        if self.breaker_fails is None:
            self.breaker_fails = 3
        if self.breaker_cooldown_s is None:
            self.breaker_cooldown_s = 1.0
        if self.hedge_quantile is None:
            self.hedge_quantile = 0.95
        if self.hedge_min_s is None:
            self.hedge_min_s = 0.05
        if self.retries is None:
            self.retries = 3
        if self.replay_concurrency is None:
            self.replay_concurrency = DEFAULT_REPLAY_CONCURRENCY
        self.timeouts = request_timeouts(self.timeouts)
        if self.replay_concurrency < 1:
            raise ValueError(f"replay_concurrency must be >= 1, "
                             f"got {self.replay_concurrency}")
        if self.max_inflight < 1:
            raise ValueError(f"max_inflight must be >= 1, "
                             f"got {self.max_inflight}")


class CircuitBreaker:
    """closed -> (N consecutive failures) -> open -> (cooldown) ->
    half-open ping probe -> closed | open. Success anywhere resets."""

    def __init__(self, fails: int, cooldown_s: float):
        self.threshold = fails
        self.cooldown_s = cooldown_s
        self.state = "closed"
        self.failures = 0
        self.opened_at = 0.0
        self.probing = False

    def _to(self, state: str) -> None:
        if state == self.state:
            return
        self.state = state
        _metrics.counter(
            "pycatkin_router_breaker_transitions_total",
            "per-replica circuit-breaker state transitions").inc(
                to=state)

    @property
    def routable(self) -> bool:
        return self.state == "closed"

    def record_success(self) -> None:
        self.failures = 0
        self._to("closed")

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == "half-open" or \
                self.failures >= self.threshold:
            self.opened_at = time.monotonic()
            self._to("open")

    def force_open(self) -> None:
        self.failures = max(self.failures, self.threshold)
        self.opened_at = time.monotonic()
        self._to("open")

    def probe_due(self) -> bool:
        return (self.state == "open" and not self.probing
                and time.monotonic() - self.opened_at
                >= self.cooldown_s)

    def begin_probe(self) -> None:
        self.probing = True
        self._to("half-open")

    def probe_result(self, ok: bool) -> None:
        self.probing = False
        if ok:
            self.record_success()
        else:
            self.opened_at = time.monotonic()
            self._to("open")


class _Link:
    """One router->replica connection; dispatches are id-multiplexed
    like :class:`serve.client.TcpSweepClient`, but failures surface as
    EXCEPTIONS (the router's retry taxonomy), and abandoned dispatches
    stay registered as *orphans* so a late answer feeds the
    duplicate-suppression audit instead of vanishing."""

    def __init__(self, idx: int, incarnation: int, host: str,
                 port: int, on_orphan):
        self.idx = idx
        self.incarnation = incarnation
        self.host = host
        self.port = port
        self.closed = False
        self._on_orphan = on_orphan
        self._reader = None
        self._writer = None
        self._task = None
        self._wlock = asyncio.Lock()
        self.pending: dict = {}    # did -> (future, audit state)
        self.orphans: dict = {}    # did -> audit state

    async def open(self, timeout_s: float) -> "_Link":
        self._reader, self._writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port,
                                    limit=LINE_LIMIT), timeout_s)
        self._task = asyncio.get_running_loop().create_task(
            self._read_loop())
        return self

    @property
    def inflight(self) -> int:
        return len(self.pending)

    async def _read_loop(self):
        try:
            while True:
                line = await self._reader.readline()
                if not line:
                    break
                try:
                    resp = json.loads(line)
                except ValueError:
                    continue   # torn replica line; deadlines recover
                did = resp.get("id")
                entry = self.pending.pop(did, None)
                if entry is not None:
                    fut, _state = entry
                    if not fut.done():
                        fut.set_result(resp)
                    continue
                state = self.orphans.pop(did, None)
                if state is not None:
                    self._on_orphan(state, resp)
        except (ConnectionError, OSError,
                asyncio.IncompleteReadError):
            pass     # severed link: the finally fails the pending
        finally:
            self.closed = True
            err = ConnectionResetError(
                f"link to replica {self.idx} closed")
            for fut, _state in self.pending.values():
                if not fut.done():
                    fut.set_exception(err)
            self.pending.clear()
            self.orphans.clear()

    def register(self, did: str, state: dict):
        fut = asyncio.get_running_loop().create_future()
        self.pending[did] = (fut, state)
        return fut

    def make_orphan(self, did: str) -> None:
        """Abandon a dispatch (timeout / hedge-loser cancellation)
        while keeping its identity alive for the duplicate audit."""
        entry = self.pending.pop(did, None)
        if entry is None:
            return
        fut, state = entry
        if fut.done() and not fut.cancelled() \
                and fut.exception() is None:
            # The answer raced our abandonment: it is already a
            # suppressed duplicate.
            self._on_orphan(state, fut.result())
        else:
            self.orphans[did] = state

    async def send_line(self, payload: dict, torn: bool = False):
        data = (json.dumps(payload) + "\n").encode()
        if torn:
            # Injected torn-line: half the JSON object, then the
            # terminator -- the replica reads one undecodable line.
            data = data[:max(1, len(data) // 2)] + b"\n"
        async with self._wlock:
            if self.closed or self._writer is None:
                raise ConnectionResetError(
                    f"link to replica {self.idx} is closed")
            self._writer.write(data)
            await self._writer.drain()

    def abort(self) -> None:
        """Hard-sever the connection (chaos conn-reset / fleet 'down'
        event): pending dispatches fail immediately with a transient
        error, which is what makes failover prompt."""
        if self._writer is not None:
            self._writer.transport.abort()

    async def close(self):
        self.closed = True
        if self._writer is not None:
            try:
                self._writer.close()
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            self._writer = None
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None


class SweepRouter:
    """The asyncio front tier over a :class:`.fleet.ReplicaSupervisor`
    (or anything with its ``endpoints()`` / ``stats()`` /
    ``add_listener`` surface, such as :class:`.fleet.FileFleet`); see
    the module docstring for the per-request behaviour."""

    def __init__(self, supervisor, config: Optional[RouterConfig] = None,
                 **overrides):
        self.supervisor = supervisor
        self.config = config or RouterConfig(**overrides)
        self.port: Optional[int] = None
        self._tcp_server = None
        self._writers: set = set()
        self._draining = False
        self._inflight = 0
        self._dseq = itertools.count()
        self._links: dict = {}
        self._retiring: set = set()
        self._breakers: dict = {}
        self._lat_interactive: deque = deque(maxlen=256)
        self._failover_samples: deque = deque(maxlen=4096)
        self._accepted = 0
        self._ok_total = 0
        self._err_total = 0
        self._retries_total = 0
        self._hedges_total = 0
        self._failovers_total = 0
        self._dup_suppressed = 0
        self._dup_identical = 0
        self._dup_mismatched = 0
        # Durable-request state. Constructing the journal replays its
        # on-disk segments, so a rebooted router knows its
        # accepted-but-unanswered backlog before it serves a request.
        self._journal = (RequestJournal(self.config.journal_dir,
                                        self.config.segment_bytes)
                         if self.config.journal_dir else None)
        self._keyed_inflight: dict = {}   # key -> future -> response
        self._dup_served = 0
        self._dup_coalesced = 0
        self._replay_task = None
        self._replay_stats = {"total": 0, "done": 0, "failed": 0,
                              "active": False, "wall_s": None}
        supervisor.add_listener(self._on_fleet_event)

    # -- lifecycle -----------------------------------------------------

    async def start(self, listen: bool = True) -> "SweepRouter":
        if listen:
            self._tcp_server = await asyncio.start_server(
                self._on_connection, self.config.host,
                self.config.port, limit=LINE_LIMIT)
            self.port = self._tcp_server.sockets[0].getsockname()[1]
            record_event("router", action="listen",
                         host=self.config.host, port=self.port)
        if self._journal is not None:
            pending = self._journal.unanswered()
            self._replay_stats["total"] = len(pending)
            if pending:
                self._replay_stats["active"] = True
                self._replay_task = asyncio.get_running_loop() \
                    .create_task(self._replay_pending(pending))
        return self

    async def drain(self) -> None:
        """Stop admitting; every ACCEPTED request still resolves (the
        retry/failover machinery keeps working while we wait), then
        the listener and links come down."""
        if self._draining:
            await self.wait_stopped()
            return
        self._draining = True
        record_event("router", action="drain-begin",
                     inflight=self._inflight)
        while self._inflight:
            await asyncio.sleep(self.config.tick_s)
        record_event("router", action="drain-complete",
                     answered=self._ok_total + self._err_total)
        await self.stop()

    async def stop(self) -> None:
        self._draining = True
        if self._replay_task is not None:
            self._replay_task.cancel()
            try:
                await self._replay_task
            except asyncio.CancelledError:
                pass
            self._replay_task = None
        if self._tcp_server is not None:
            self._tcp_server.close()
            # Server.wait_closed waits for every open connection (Python
            # 3.12), so the client connections are closed here: a drain
            # has answered every accepted request by now.
            for w in list(self._writers):
                w.close()
            await self._tcp_server.wait_closed()
            self._tcp_server = None
        for link in list(self._links.values()):
            await link.close()
        self._links.clear()
        if self._retiring:
            await asyncio.gather(*list(self._retiring),
                                 return_exceptions=True)

    async def wait_stopped(self) -> None:
        while self._tcp_server is not None or self._inflight:
            await asyncio.sleep(self.config.tick_s)

    @property
    def draining(self) -> bool:
        return self._draining

    # -- boot-time journal replay --------------------------------------

    async def _replay_pending(self, pending: list) -> None:
        """Recovery after router death: every journaled
        accepted-but-unanswered request is re-dispatched to the fleet
        (bounded concurrency) through the ordinary keyed sweep path,
        so its answer lands in the journal and duplicate resubmissions
        from reconnecting clients coalesce onto the same dispatch."""
        t0 = time.monotonic()
        record_event("durable", action="replay-begin",
                     pending=len(pending))

        sem = asyncio.Semaphore(self.config.replay_concurrency)

        async def one(n: int, key: str, payload) -> None:
            async with sem:
                if self._journal.answered_response(key) is not None:
                    self._replay_stats["done"] += 1
                    return   # a client resubmission beat us to it
                req = dict(payload) if isinstance(payload, dict) else {}
                req["idempotency_key"] = key
                req.setdefault("op", "sweep")
                req["id"] = f"replay-{n}"
                resp = None
                # A replica breaker may still be warming right after
                # boot; overload rejects here would silently park the
                # request until the NEXT boot, so back off and retry.
                for attempt in range(8):
                    resp = await self.handle(req)
                    code = ((resp.get("error") or {}).get("code")
                            if not resp.get("ok") else None)
                    if code != E_OVERLOADED:
                        break
                    await asyncio.sleep(backoff_delay(attempt, 0.1,
                                                      2.0))
                if resp is not None and resp.get("ok"):
                    self._replay_stats["done"] += 1
                else:
                    self._replay_stats["failed"] += 1

        try:
            await asyncio.gather(
                *(one(n, key, payload)
                  for n, (key, payload) in enumerate(pending)),
                return_exceptions=True)
        finally:
            self._replay_stats["active"] = False
            self._replay_stats["wall_s"] = time.monotonic() - t0
            record_event("durable", action="replay-complete",
                         done=self._replay_stats["done"],
                         failed=self._replay_stats["failed"],
                         wall_s=self._replay_stats["wall_s"])

    # -- fleet events --------------------------------------------------

    def _breaker(self, idx: int) -> CircuitBreaker:
        br = self._breakers.get(idx)
        if br is None:
            br = self._breakers[idx] = CircuitBreaker(
                self.config.breaker_fails,
                self.config.breaker_cooldown_s)
        return br

    def _on_fleet_event(self, info: dict) -> None:
        idx = info["idx"]
        br = self._breaker(idx)
        if info["event"] == "up":
            # A freshly registered incarnation already won a ping.
            br.record_success()
            return
        br.force_open()
        link = self._links.pop(idx, None)
        if link is not None:
            # Sever now so in-flight dispatches fail over immediately
            # instead of waiting out their attempt timeout; the read
            # task is then reaped in the background (an aborted link
            # must not outlive the router).
            link.abort()
            task = asyncio.get_running_loop().create_task(link.close())
            self._retiring.add(task)
            task.add_done_callback(self._retiring.discard)

    # -- replica selection ---------------------------------------------

    async def _link_for(self, ep: dict) -> _Link:
        idx = ep["idx"]
        link = self._links.get(idx)
        if link is not None and not link.closed \
                and link.incarnation == ep["incarnation"]:
            return link
        if link is not None:
            link.abort()
            await link.close()
        link = _Link(idx, ep["incarnation"], ep["host"], ep["port"],
                     self._suppress_duplicate)
        await link.open(self.config.connect_timeout_s)
        cur = self._links.get(idx)
        if cur is not None and not cur.closed \
                and cur.incarnation == ep["incarnation"]:
            # Lost an open race against a concurrent dispatch: keep
            # the established link, reap ours (its read task must not
            # be orphaned).
            await link.close()
            return cur
        self._links[idx] = link
        return link

    def _kick_probes(self) -> None:
        """Schedule half-open probes for every cooled-down open
        breaker. Called from BOTH the candidate scan and the
        all-breakers-open admission reject: if only the dispatch path
        probed, a router rejecting everything would never discover
        that its replicas recovered."""
        for ep in self.supervisor.endpoints():
            br = self._breaker(ep["idx"])
            if br.probe_due():
                asyncio.get_running_loop().create_task(
                    self._probe_breaker(ep, br))

    def _candidates(self, tried=frozenset()) -> list:
        self._kick_probes()
        eps = []
        for ep in self.supervisor.endpoints():
            br = self._breaker(ep["idx"])
            if br.routable:
                eps.append(ep)
        if not eps:
            return []
        fresh = [e for e in eps if e["idx"] not in tried]
        pool = fresh or eps
        pool.sort(key=lambda e: (
            self._links[e["idx"]].inflight
            if e["idx"] in self._links else 0))
        return pool

    def _any_breaker_routable(self) -> bool:
        return any(self._breaker(ep["idx"]).routable
                   for ep in self.supervisor.endpoints())

    async def _probe_breaker(self, ep: dict, br: CircuitBreaker):
        """half-open ping probe over a fresh connection; closes the
        breaker on success without risking live traffic."""
        br.begin_probe()
        writer = None
        ok = False
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(ep["host"], ep["port"]),
                self.config.probe_timeout_s)
            writer.write(b'{"op": "ping", "id": "breaker-probe"}\n')
            await writer.drain()
            line = await asyncio.wait_for(
                reader.readline(), self.config.probe_timeout_s)
            resp = json.loads(line) if line.strip() else None
            ok = bool(isinstance(resp, dict) and resp.get("ok"))
        except (OSError, ValueError, asyncio.TimeoutError):
            ok = False
        finally:
            if writer is not None:
                writer.close()
        br.probe_result(ok)
        record_event("router", action="breaker-probe",
                     replica=ep["idx"], ok=ok)

    # -- duplicate-suppression audit -----------------------------------

    def _suppress_duplicate(self, state: dict, resp: dict) -> None:
        """A dispatch the router abandoned answered anyway. The client
        never sees it; the audit proves it WOULD have been the same
        answer (same-width sweeps are deterministic, so anything else
        is a real bug, not noise)."""
        if not resp.get("ok"):
            return                       # errors carry no answer
        self._dup_suppressed += 1
        chosen = state.get("canonical")
        if chosen is None:
            state.setdefault("dups", []).append(_canonical(resp))
            _metrics.counter(
                "pycatkin_router_duplicates_suppressed_total",
                "late/hedge-loser answers suppressed by the "
                "router").inc(identical="pending")
            return
        identical = _canonical(resp) == chosen
        self._dup_identical += int(identical)
        self._dup_mismatched += int(not identical)
        _metrics.counter(
            "pycatkin_router_duplicates_suppressed_total",
            "late/hedge-loser answers suppressed by the router").inc(
                identical=str(identical).lower())
        if not identical:
            record_event("router", action="duplicate-mismatch",
                         req_id=state.get("req_id"))

    def _finalize_audit(self, state: dict, resp: dict) -> None:
        if not resp.get("ok"):
            return
        state["canonical"] = _canonical(resp)
        for dup in state.pop("dups", []):
            identical = dup == state["canonical"]
            self._dup_identical += int(identical)
            self._dup_mismatched += int(not identical)
            if not identical:
                record_event("router", action="duplicate-mismatch",
                             req_id=state.get("req_id"))

    # -- request handling ----------------------------------------------

    async def handle(self, payload, ack=None) -> dict:
        req_id = payload.get("id") if isinstance(payload, dict) else None
        try:
            if not isinstance(payload, dict):
                raise ServeError(E_BAD_REQUEST,
                                 "expected a JSON object per line")
            op = payload.get("op", "sweep")
            _metrics.counter("pycatkin_router_requests_total",
                             "requests seen by the front router").inc(
                                 op=str(op))
            if op == "ping":
                return {"protocol": PROTOCOL, "id": req_id, "ok": True,
                        "pong": True, "draining": self._draining,
                        "replicas_up": len(self.supervisor.endpoints())}
            if op == "stats":
                return {"protocol": PROTOCOL, "id": req_id, "ok": True,
                        "stats": self.stats()}
            if op == "drain":
                asyncio.get_running_loop().create_task(self.drain())
                return {"protocol": PROTOCOL, "id": req_id, "ok": True,
                        "draining": True}
            if op == "result":
                return self._fetch_result(payload, req_id)
            if op == "sweep":
                return await self._route_sweep(payload, req_id, ack)
            raise ServeError(E_BAD_REQUEST, f"unknown op {op!r}")
        except ServeError as exc:
            return error_response(req_id, exc.code, str(exc))
        except Exception as exc:  # noqa: BLE001 - wire boundary
            return error_response(req_id, E_INTERNAL,
                                  f"{type(exc).__name__}: {exc}")

    def _fetch_result(self, payload: dict, req_id) -> dict:
        """``{"op": "result", "key": ...}``: fetch the journaled answer
        for an idempotency key -- how a reconnecting client retrieves
        an answer it may have missed, without re-running anything."""
        if self._journal is None:
            raise ServeError(E_BAD_REQUEST,
                             "durability is not enabled on this router "
                             "(no journal dir)")
        key = payload.get("key")
        if not isinstance(key, str) or not key:
            raise ServeError(E_BAD_REQUEST,
                             "/key: expected a non-empty string")
        stored = self._journal.answered_response(key)
        if stored is not None:
            return dict(stored, id=req_id)
        if key in self._keyed_inflight or self._journal.is_accepted(key):
            raise ServeError(E_UNKNOWN_KEY,
                             f"key {key!r} is accepted but not yet "
                             "answered; retry shortly")
        raise ServeError(E_UNKNOWN_KEY,
                         f"no journaled answer for key {key!r} (never "
                         "accepted, or compacted out of the window)")

    async def _route_sweep(self, payload: dict, req_id,
                           ack=None) -> dict:
        cls = str(payload.get("deadline_class", "standard"))
        key = payload.get("idempotency_key")
        key = (str(key) if key is not None and self._journal is not None
               else None)
        if key is not None:
            # Duplicate of an answered key: serve the journaled answer
            # bitwise (only the id is rewritten) -- even while
            # draining, a replayed answer is a read, not new work.
            stored = self._journal.answered_response(key)
            if stored is not None:
                self._dup_served += 1
                _metrics.counter(
                    "pycatkin_durable_duplicates_served_total",
                    "keyed duplicates answered from the journal").inc()
                record_event("durable", action="dup-served", key=key)
                return dict(stored, id=req_id)
            inflight_fut = self._keyed_inflight.get(key)
            if inflight_fut is not None:
                # Same key already being dispatched (client
                # resubmission racing the original or the boot-time
                # replay): coalesce onto one dispatch.
                self._dup_coalesced += 1
                try:
                    resp = await asyncio.wait_for(
                        asyncio.shield(inflight_fut),
                        request_timeout_for(cls, self.config.timeouts))
                except asyncio.TimeoutError:
                    raise ServeError(
                        E_TIMEOUT,
                        f"coalesced dispatch for key {key!r} burned "
                        "the SLA budget") from None
                return dict(resp, id=req_id)
        if self._draining:
            raise ServeError(E_DRAINING,
                             "router is draining; no new sweeps")
        if self._inflight >= self.config.max_inflight:
            raise ServeError(
                E_OVERLOADED,
                f"router in-flight cap reached ({self._inflight} >= "
                f"{self.config.max_inflight}); retry with backoff")
        if not self._any_breaker_routable():
            self._kick_probes()
            raise ServeError(E_OVERLOADED,
                             "every replica breaker is open; "
                             "retry with backoff")
        keyed_fut = None
        if key is not None:
            keyed_fut = asyncio.get_running_loop().create_future()
            self._keyed_inflight[key] = keyed_fut
            try:
                # Durability contract: the accepted record is FSYNCED
                # (append_json_line) before the ack line may reach the
                # socket -- a key the client saw acknowledged survives
                # router death.
                await asyncio.to_thread(self._journal.record_accepted,
                                        key,
                                        {k: v for k, v in payload.items()
                                         if k != "id"})
            except BaseException:
                self._keyed_inflight.pop(key, None)
                keyed_fut.cancel()
                raise
            if ack is not None:
                await ack(accepted_ack(req_id, key))
        self._accepted += 1
        self._inflight += 1
        _metrics.gauge("pycatkin_router_inflight",
                       "sweeps in flight through the router").set(
                           float(self._inflight))
        t0 = time.monotonic()
        state = {"req_id": req_id, "canonical": None}
        try:
            resp = await self._dispatch_with_retries(payload, cls,
                                                     state, t0)
        except ServeError as exc:
            self._err_total += 1
            if keyed_fut is not None:
                self._resolve_key(key, keyed_fut,
                                  error_response(req_id, exc.code,
                                                 str(exc)))
            raise
        except BaseException:
            if keyed_fut is not None:
                self._resolve_key(key, keyed_fut,
                                  error_response(req_id, E_INTERNAL,
                                                 "dispatch aborted"))
            raise
        finally:
            self._inflight -= 1
            _metrics.gauge("pycatkin_router_inflight",
                           "sweeps in flight through the router").set(
                               float(self._inflight))
        total_s = time.monotonic() - t0
        _metrics.histogram(
            "pycatkin_router_request_seconds",
            "routed sweep wall time, admission to answer").observe(
                total_s, deadline_class=cls)
        if cls == "interactive":
            self._lat_interactive.append(total_s)
        if resp.get("ok"):
            self._ok_total += 1
        else:
            self._err_total += 1
        self._finalize_audit(state, resp)
        resp = dict(resp, id=req_id)
        if keyed_fut is not None:
            if resp.get("ok"):
                # Answered BEFORE the client can see the response; a
                # prior record means a replay/resubmission race, and
                # the two answers are audited like hedge losers.
                prior = await asyncio.to_thread(
                    self._journal.record_answered, key, resp)
                if prior is not None:
                    identical = (canonical_answer(prior)
                                 == canonical_answer(resp))
                    self._dup_identical += int(identical)
                    self._dup_mismatched += int(not identical)
                    if not identical:
                        record_event("router",
                                     action="duplicate-mismatch",
                                     req_id=req_id)
                    resp = dict(prior, id=req_id)
            self._resolve_key(key, keyed_fut, resp)
        return resp

    def _resolve_key(self, key: str, fut, resp: dict) -> None:
        self._keyed_inflight.pop(key, None)
        if not fut.done():
            fut.set_result(resp)

    async def _dispatch_with_retries(self, payload: dict, cls: str,
                                     state: dict, t0: float) -> dict:
        cfg = self.config
        budget = request_timeout_for(cls, self.config.timeouts)
        deadline = t0 + budget
        failures = 0
        first_failure_at = None
        last_err = "no replica available"
        tried: set = set()
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise ServeError(
                    E_TIMEOUT,
                    f"SLA budget burned ({budget:.3f} s, class "
                    f"{cls!r}) after {failures} failed dispatch "
                    f"attempt(s); last error: {last_err}")
            cands = self._candidates(tried)
            if not cands:
                # Nothing routable RIGHT NOW; the supervisor may be
                # rebooting a replica. Wait it out under the budget.
                await asyncio.sleep(min(cfg.tick_s, remaining))
                continue
            attempt_timeout = min(
                remaining, max(budget / (cfg.retries + 1),
                               cfg.hedge_min_s))
            try:
                if cls == "interactive" and len(cands) > 1:
                    resp = await self._hedged_dispatch(
                        cands, payload, state, attempt_timeout)
                else:
                    resp = await self._dispatch_once(
                        cands[0], payload, state, attempt_timeout)
            except Exception as exc:  # noqa: BLE001 - classified below
                if not is_transient_backend_error(exc) \
                        and not isinstance(exc, OSError):
                    raise ServeError(
                        E_INTERNAL,
                        f"dispatch failed: {type(exc).__name__}: "
                        f"{exc}") from exc
                failures += 1
                last_err = f"{type(exc).__name__}: {exc}"
                if first_failure_at is None:
                    first_failure_at = time.monotonic()
                self._retries_total += 1
                _metrics.counter(
                    "pycatkin_router_retries_total",
                    "dispatch attempts retried by the router").inc()
                tried.update(getattr(exc, "_replica_idx", ()) or ())
                if failures > cfg.retries:
                    raise ServeError(
                        E_INTERNAL,
                        f"{failures} dispatch failures (retry budget "
                        f"{cfg.retries}); last error: {last_err}") \
                        from exc
                delay = backoff_delay(failures - 1,
                                      cfg.retry_base_delay_s,
                                      cfg.retry_max_delay_s)
                await asyncio.sleep(
                    min(delay, max(0.0,
                                   deadline - time.monotonic())))
                continue
            if not resp.get("ok") and \
                    (resp.get("error") or {}).get("code") \
                    in _FAILOVER_CODES:
                # The replica said "not me" -- the fleet has spares.
                failures += 1
                last_err = f"replica said {resp['error']['code']}"
                if first_failure_at is None:
                    first_failure_at = time.monotonic()
                tried.add(resp.pop("_replica_idx", None))
                if failures > cfg.retries:
                    return resp
                await asyncio.sleep(min(cfg.tick_s, remaining))
                continue
            if failures and resp.get("ok"):
                self._failovers_total += 1
                _metrics.counter(
                    "pycatkin_router_failovers_total",
                    "requests answered after losing a replica "
                    "mid-flight").inc()
                self._failover_samples.append(
                    time.monotonic() - first_failure_at)
            resp.pop("_replica_idx", None)
            return resp

    async def _dispatch_once(self, ep: dict, payload: dict,
                             state: dict, timeout_s: float) -> dict:
        from ..robustness import faults
        idx = ep["idx"]
        br = self._breaker(idx)
        try:
            link = await self._link_for(ep)
        except (OSError, asyncio.TimeoutError) as exc:
            br.record_failure()
            exc._replica_idx = (idx,)
            raise
        did = f"d{next(self._dseq)}"
        site = f"router:dispatch:{did}"
        torn = False
        for spec in faults.take(site, kinds=ROUTER_FAULT_KINDS):
            record_event("router", action="chaos-enact", replica=idx,
                         label=site, fault_kind=spec.kind)
            if spec.kind == "conn-reset":
                link.abort()
                br.record_failure()
                err = ConnectionResetError(
                    f"injected conn-reset at {site}")
                err._replica_idx = (idx,)
                raise err
            torn = True
        fut = link.register(did, state)
        try:
            await link.send_line(dict(payload, id=did), torn=torn)
            resp = await asyncio.wait_for(asyncio.shield(fut),
                                          timeout_s)
        except asyncio.TimeoutError as exc:
            link.make_orphan(did)
            br.record_failure()
            err = TimeoutError(
                f"replica {idx} gave no answer for {did} within "
                f"{timeout_s:.3f} s")
            err._replica_idx = (idx,)
            raise err from exc
        except asyncio.CancelledError:
            link.make_orphan(did)
            raise
        except Exception as exc:      # noqa: BLE001 - tagged, re-raised
            link.make_orphan(did)
            br.record_failure()
            exc._replica_idx = (idx,)
            raise
        br.record_success()
        resp = dict(resp, _replica_idx=idx)
        return resp

    def _hedge_delay_s(self) -> float:
        lat = self._lat_interactive
        if len(lat) >= 8:
            s = sorted(lat)
            q = s[min(len(s) - 1,
                      int(self.config.hedge_quantile * len(s)))]
            return max(q, self.config.hedge_min_s)
        return self.config.hedge_min_s

    async def _hedged_dispatch(self, cands: list, payload: dict,
                               state: dict, timeout_s: float) -> dict:
        """interactive-class dispatch: engage a second replica at the
        latency quantile; first answer wins, the loser is cancelled
        (its late answer, if any, feeds the duplicate audit)."""
        loop = asyncio.get_running_loop()
        t1 = loop.create_task(self._dispatch_once(
            cands[0], payload, state, timeout_s))
        try:
            return await asyncio.wait_for(asyncio.shield(t1),
                                          self._hedge_delay_s())
        except asyncio.TimeoutError:
            pass
        self._hedges_total += 1
        _metrics.counter(
            "pycatkin_router_hedges_total",
            "interactive dispatches hedged to a second replica").inc()
        record_event("router", action="hedge", primary=cands[0]["idx"],
                     secondary=cands[1]["idx"])
        t2 = loop.create_task(self._dispatch_once(
            cands[1], payload, state, timeout_s))
        tasks = {t1, t2}
        winner = None
        first_exc = None
        while tasks and winner is None:
            done, tasks = await asyncio.wait(
                tasks, return_when=asyncio.FIRST_COMPLETED)
            for d in done:
                try:
                    r = await d
                except asyncio.CancelledError:
                    continue
                except Exception as exc:  # noqa: BLE001 - kept, rethrown
                    if first_exc is None:
                        first_exc = exc
                    continue
                if winner is None:
                    winner = r
                else:
                    self._suppress_duplicate(state, r)
        for t in tasks:
            t.cancel()   # loser: its dispatch orphans itself
        if winner is not None:
            return winner
        if first_exc is None:      # both legs cancelled under us
            first_exc = ConnectionResetError(
                "hedged dispatch lost both replicas")
        raise first_exc

    # -- introspection -------------------------------------------------

    def stats(self) -> dict:
        answered = self._ok_total + self._err_total
        samples = sorted(self._failover_samples)
        p99 = (samples[min(len(samples) - 1,
                           int(0.99 * len(samples)))]
               if samples else None)
        return {
            "protocol": PROTOCOL,
            "draining": self._draining,
            "port": self.port,
            "inflight": self._inflight,
            "accepted": self._accepted,
            "ok_total": self._ok_total,
            "err_total": self._err_total,
            "availability": (self._ok_total / answered
                             if answered else None),
            "retries": self._retries_total,
            "hedges": self._hedges_total,
            "failovers": self._failovers_total,
            "failover_p99_s": p99,
            "duplicates": {"suppressed": self._dup_suppressed,
                           "identical": self._dup_identical,
                           "mismatched": self._dup_mismatched},
            "breakers": {str(i): br.state
                         for i, br in sorted(self._breakers.items())},
            "fleet": self.supervisor.stats(),
            "durable": (None if self._journal is None else {
                "journal": self._journal.stats(),
                "replay": dict(self._replay_stats),
                "duplicates_served": self._dup_served,
                "coalesced": self._dup_coalesced,
                "keyed_inflight": len(self._keyed_inflight),
            }),
        }

    # -- TCP framing ---------------------------------------------------

    async def _on_connection(self, reader: asyncio.StreamReader,
                             writer: asyncio.StreamWriter):
        wlock = asyncio.Lock()
        tasks = set()
        self._writers.add(writer)

        async def ack_line(obj: dict):
            # The durability ack: _route_sweep only calls this after
            # the accepted record is fsynced (fsync-before-ack). A
            # dead client is not an error -- it will reconnect and
            # resubmit by key.
            data = (json.dumps(obj) + "\n").encode()
            try:
                async with wlock:
                    writer.write(data)
                    await writer.drain()
            except (ConnectionError, OSError):
                pass

        async def one_line(line: bytes):
            try:
                try:
                    payload = json.loads(line)
                except ValueError as exc:
                    resp = error_response(None, E_BAD_REQUEST,
                                          f"invalid JSON: {exc}")
                else:
                    resp = await self.handle(payload, ack=ack_line)
                data = (json.dumps(resp) + "\n").encode()
                async with wlock:
                    writer.write(data)
                    await writer.drain()
            except (ConnectionError, asyncio.CancelledError):
                pass

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


# The canonicalizer lives in protocol.py (canonical_answer), so that the
# request journal records it without importing the router; the JAX
# package's name stays importable for the soak harness and tests.
_canonical = canonical_answer
