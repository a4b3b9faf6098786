"""Clients of the sweep service: in process and JSON lines over TCP (port
of ``pycatkin_tpu/serve/client.py``).

:class:`SweepClient` talks straight to a :class:`.server.SweepServer` in
the same process -- no serialization, and the mechanism may be a built
``System``. :class:`TcpSweepClient` speaks the wire protocol; it
multiplexes any number of in-flight requests over one connection by
matching response ``id`` to request ``id``, which is what lets K
co-tenants of a packed group be pending at once from one client.

Severed connections: pending requests without an idempotency key fail at
once with a structured ``E_CONN_LOST`` naming the peer (resubmitting
them is not known to be safe). Requests with a key survive: the client
reconnects within a bounded-backoff window (counted in
``pycatkin_serve_reconnects_total``) and resubmits them verbatim.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import time
from typing import Optional

from ..utils.retry import backoff_delay
from .protocol import (E_CONN_LOST, E_TIMEOUT, LINE_LIMIT, error_response,
                       request_timeout_for, request_timeouts)

# A connection delivering this many CONSECUTIVE undecodable lines is
# torn, not merely glitched: fail every pending request fast instead of
# letting callers sit on futures that will never resolve. One bad line
# (a torn final write from a dying server) only bumps the metric; the
# streak resets on the next good line.
TORN_LINE_LIMIT = 8

_UNSET = object()


def sweep_payload(mechanism, T, p=1.0e5, tof_terms=None,
                  deadline_class: str = "standard",
                  wait_budget_s: Optional[float] = None,
                  want=(), req_id=None,
                  idempotency_key: Optional[str] = None) -> dict:
    """Assemble one sweep request object (``pycatkin-serve/v1``)."""
    payload = {
        "op": "sweep", "id": req_id, "mechanism": mechanism,
        "conditions": {
            "T": list(T) if isinstance(T, (list, tuple)) else [T],
            "p": list(p) if isinstance(p, (list, tuple)) else p},
        "deadline_class": deadline_class,
    }
    if tof_terms:
        payload["tof_terms"] = list(tof_terms)
    if wait_budget_s is not None:
        payload["wait_budget_s"] = float(wait_budget_s)
    if want:
        payload["return"] = list(want)
    if idempotency_key is not None:
        payload["idempotency_key"] = str(idempotency_key)
    return payload


def transient_payload(mechanism, T, save_ts, p=1.0e5,
                      deadline_class: str = "standard",
                      wait_budget_s: Optional[float] = None,
                      want=(), req_id=None,
                      idempotency_key: Optional[str] = None) -> dict:
    """Assemble one transient request object: a sweep-shaped conditions
    grid plus the dense-output save-time grid (``save_ts[0]`` must be 0,
    strictly increasing)."""
    payload = {
        "op": "transient", "id": req_id, "mechanism": mechanism,
        "conditions": {
            "T": list(T) if isinstance(T, (list, tuple)) else [T],
            "p": list(p) if isinstance(p, (list, tuple)) else p},
        "save_ts": [float(t) for t in save_ts],
        "deadline_class": deadline_class,
    }
    if wait_budget_s is not None:
        payload["wait_budget_s"] = float(wait_budget_s)
    if want:
        payload["return"] = list(want)
    if idempotency_key is not None:
        payload["idempotency_key"] = str(idempotency_key)
    return payload


class SweepClient:
    """In-process client: calls the server's request handler directly.
    The ``mechanism`` may be a built ``System`` (skipping the JSON
    round-trip) or a reference-schema dict."""

    def __init__(self, server):
        self._server = server
        self._seq = itertools.count()

    async def sweep(self, mechanism, T, p=1.0e5, **kwargs) -> dict:
        req_id = kwargs.pop("req_id", None) or f"c{next(self._seq)}"
        return await self._server.handle(
            sweep_payload(mechanism, T, p=p, req_id=req_id, **kwargs))

    async def transient(self, mechanism, T, save_ts, p=1.0e5,
                        **kwargs) -> dict:
        req_id = kwargs.pop("req_id", None) or f"c{next(self._seq)}"
        return await self._server.handle(
            transient_payload(mechanism, T, save_ts, p=p,
                              req_id=req_id, **kwargs))

    async def ping(self) -> dict:
        return await self._server.handle({"op": "ping"})

    async def stats(self) -> dict:
        return await self._server.handle({"op": "stats"})

    async def drain(self) -> dict:
        return await self._server.handle({"op": "drain"})


class TcpSweepClient:
    """JSON-lines TCP client with id-multiplexed in-flight requests
    and (by default) auto-reconnect; see the module docstring for the
    severed-connection contract."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 reconnect: bool = True,
                 reconnect_window_s: float = 60.0,
                 reconnect_base_delay_s: float = 0.05,
                 reconnect_max_delay_s: float = 2.0,
                 timeouts=None):
        self.host = host
        self.port = port
        self.reconnect = reconnect
        self.reconnect_window_s = float(reconnect_window_s)
        self.reconnect_base_delay_s = float(reconnect_base_delay_s)
        self.reconnect_max_delay_s = float(reconnect_max_delay_s)
        # Per-class request timeouts over the defaults
        # (protocol.request_timeouts), e.g. {"interactive": 120.0}.
        self.timeouts = request_timeouts(timeouts)
        self._reader = None
        self._writer = None
        self._pending: dict = {}     # id -> future
        self._payloads: dict = {}    # id -> request payload (resubmit)
        self._seq = itertools.count()
        self._read_task = None
        self._reconnect_task = None
        self._wlock = asyncio.Lock()
        self._closing = False
        self.torn_lines = 0
        self.reconnects = 0
        self.acks = 0                # durability ack lines received

    async def connect(self) -> "TcpSweepClient":
        await self._open()
        return self

    async def _open(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port, limit=LINE_LIMIT)
        self._read_task = asyncio.get_running_loop().create_task(
            self._read_loop())

    def _connected(self) -> bool:
        return (self._writer is not None
                and self._read_task is not None
                and not self._read_task.done())

    @property
    def _peer(self) -> str:
        return f"{self.host}:{self.port}"

    async def _read_loop(self):
        from ..obs import metrics
        torn = metrics.counter(
            "pycatkin_serve_torn_lines_total",
            "undecodable JSON lines received by serve TCP clients")
        why = "connection closed"
        streak = 0
        try:
            while True:
                line = await self._reader.readline()
                if not line:
                    break
                try:
                    resp = json.loads(line)
                except ValueError:
                    # A torn line (partial write from a dying peer) is
                    # accounted, never silently dropped; the sender
                    # retries by id, so the lost response is recovered
                    # upstream.
                    self.torn_lines += 1
                    torn.inc()
                    streak += 1
                    if streak >= TORN_LINE_LIMIT:
                        why = (f"{streak} consecutive undecodable "
                               f"lines: stream torn")
                        break
                    continue
                streak = 0
                if resp.get("accepted") is True and "ok" not in resp:
                    # Durability ack (protocol.accepted_ack): the
                    # request is journaled router-side; its real
                    # answer follows under the same id.
                    self.acks += 1
                    continue
                rid = resp.get("id")
                fut = self._pending.pop(rid, None)
                self._payloads.pop(rid, None)
                if fut is not None and not fut.done():
                    fut.set_result(resp)
        except (ConnectionError, OSError,
                asyncio.IncompleteReadError) as exc:
            why = f"connection lost: {exc}"
        finally:
            self._on_conn_lost(why)

    def _conn_lost_error(self, rid, why: str, has_key: bool) -> dict:
        if has_key:
            hint = "an idempotency key, so resubmitting is safe"
        else:
            hint = ("no idempotency key, so resubmitting is NOT "
                    "known to be safe")
        return error_response(
            rid, E_CONN_LOST,
            f"connection to {self._peer} lost ({why}); "
            f"request had {hint}",
            peer=self._peer, idempotency_key=has_key)

    def _on_conn_lost(self, why: str) -> None:
        """The connection died under ``self._pending``: fail keyless
        requests with a structured ``E_CONN_LOST``; keep keyed ones
        pending and reconnect to resubmit them."""
        if self._writer is not None:
            try:
                self._writer.transport.abort()
            except (ConnectionError, OSError, RuntimeError):
                pass
        survivors = 0
        for rid, fut in list(self._pending.items()):
            payload = self._payloads.get(rid)
            has_key = bool(isinstance(payload, dict)
                           and payload.get("idempotency_key"))
            if has_key and self.reconnect and not self._closing:
                survivors += 1
                continue
            self._pending.pop(rid, None)
            self._payloads.pop(rid, None)
            if not fut.done():
                fut.set_result(self._conn_lost_error(rid, why, has_key))
        if survivors and not self._closing:
            self._ensure_reconnect()

    def _ensure_reconnect(self) -> None:
        if not self.reconnect or self._closing:
            return
        if self._reconnect_task is None or self._reconnect_task.done():
            self._reconnect_task = asyncio.get_running_loop() \
                .create_task(self._reconnect())

    async def _reconnect(self) -> None:
        from ..obs import metrics
        deadline = time.monotonic() + self.reconnect_window_s
        attempt = 0
        while not self._closing and not self._connected():
            try:
                await self._open()
            except (ConnectionError, OSError,
                    asyncio.TimeoutError) as exc:
                attempt += 1
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._fail_pending(
                        f"reconnect window "
                        f"({self.reconnect_window_s:.0f} s) exhausted; "
                        f"last error: {exc}")
                    return
                await asyncio.sleep(min(
                    backoff_delay(attempt - 1,
                                  self.reconnect_base_delay_s,
                                  self.reconnect_max_delay_s),
                    remaining))
                continue
            self.reconnects += 1
            metrics.counter(
                "pycatkin_serve_reconnects_total",
                "serve TCP client reconnects after a severed "
                "connection").inc()
        # Resubmit everything still unanswered, verbatim (same ids;
        # keyed requests dedup in the router's journal, so the caller
        # can never see two answers for one key).
        if self._connected():
            for rid, payload in list(self._payloads.items()):
                if rid not in self._pending:
                    continue
                try:
                    await self._send(payload)
                except (ConnectionError, OSError):
                    return   # the read loop reports the loss again

    def _fail_pending(self, why: str) -> None:
        for rid, fut in list(self._pending.items()):
            payload = self._payloads.get(rid)
            has_key = bool(isinstance(payload, dict)
                           and payload.get("idempotency_key"))
            if not fut.done():
                fut.set_result(self._conn_lost_error(rid, why, has_key))
        self._pending.clear()
        self._payloads.clear()

    async def _send(self, payload: dict) -> None:
        data = (json.dumps(payload) + "\n").encode()
        async with self._wlock:
            if self._writer is None:
                raise ConnectionResetError(
                    f"not connected to {self._peer}")
            self._writer.write(data)
            await self._writer.drain()

    async def _send_after_reconnect(self, payload: dict) -> bool:
        """The initial send hit a dead connection: wait out one
        reconnect cycle, then send again (a duplicate line is safe --
        responses are matched by id and keyed requests dedup
        router-side). Returns False when the request cannot be
        delivered."""
        if not self.reconnect or self._closing:
            return False
        self._ensure_reconnect()
        task = self._reconnect_task
        if task is not None:
            try:
                await asyncio.wait_for(asyncio.shield(task),
                                       self.reconnect_window_s + 5.0)
            except (asyncio.TimeoutError, ConnectionError, OSError):
                pass
        if not self._connected():
            return False
        try:
            await self._send(payload)
        except (ConnectionError, OSError):
            return False
        return True

    async def request(self, payload: dict, timeout=_UNSET) -> dict:
        """Send one request object; resolves when ITS response (by
        ``id``) arrives, regardless of interleaving.

        Every request carries a deadline: ``timeout`` defaults to the
        payload's deadline-class request timeout (the client's
        ``timeouts``, :func:`protocol.request_timeout_for`), so a stalled -- not
        closed -- server resolves to a structured ``E_TIMEOUT`` error
        instead of hanging the caller forever. Pass ``timeout=None``
        to wait indefinitely, or a float to override."""
        if payload.get("id") is None:
            payload = dict(payload, id=f"t{next(self._seq)}")
        if timeout is _UNSET:
            timeout = request_timeout_for(
                payload.get("deadline_class", "standard"), self.timeouts)
        req_id = payload["id"]
        fut = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        self._payloads[req_id] = payload
        try:
            try:
                await self._send(payload)
            except (ConnectionError, OSError) as exc:
                if not await self._send_after_reconnect(payload):
                    self._pending.pop(req_id, None)
                    has_key = bool(payload.get("idempotency_key"))
                    if not fut.done():
                        fut.set_result(self._conn_lost_error(
                            req_id, f"send failed: {exc}", has_key))
                    return await fut
            try:
                return await asyncio.wait_for(asyncio.shield(fut),
                                              timeout)
            except asyncio.TimeoutError:
                self._pending.pop(req_id, None)
                if fut.done():     # answer raced the deadline: keep it
                    return fut.result()
                fut.cancel()
                return error_response(
                    req_id, E_TIMEOUT,
                    f"no response within {timeout:.3f} s "
                    f"(deadline_class "
                    f"{payload.get('deadline_class', 'standard')!r})")
        finally:
            self._payloads.pop(req_id, None)
            self._pending.pop(req_id, None)

    async def sweep(self, mechanism, T, p=1.0e5, **kwargs) -> dict:
        return await self.request(
            sweep_payload(mechanism, T, p=p, **kwargs))

    async def transient(self, mechanism, T, save_ts, p=1.0e5,
                        **kwargs) -> dict:
        return await self.request(
            transient_payload(mechanism, T, save_ts, p=p, **kwargs))

    async def ping(self) -> dict:
        return await self.request({"op": "ping"})

    async def stats(self) -> dict:
        return await self.request({"op": "stats"})

    async def drain(self) -> dict:
        return await self.request({"op": "drain"})

    async def fetch_result(self, key: str) -> dict:
        """Fetch the journaled answer for an idempotency key (the
        ``result`` op; journal-backed routers only)."""
        return await self.request({"op": "result", "key": str(key)})

    async def close(self):
        self._closing = True
        if self._reconnect_task is not None:
            self._reconnect_task.cancel()
            try:
                await self._reconnect_task
            except asyncio.CancelledError:
                pass
            self._reconnect_task = None
        if self._writer is not None:
            try:
                self._writer.close()
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            self._writer = None
        if self._read_task is not None:
            self._read_task.cancel()
            try:
                await self._read_task
            except asyncio.CancelledError:
                pass
            self._read_task = None
        self._fail_pending("client closed")
