"""Stub replicas and a fake supervisor for the port's fleet-tier tests
(``test_torch_router.py``, ``test_torch_durable.py``).

The router moves bytes only, so it is tested against stub TCP replicas
that speak the wire protocol, the same stubs for the JAX package's
router and the port's. Every stub closes its connections when it stops:
on Python 3.12 ``Server.wait_closed`` waits for every open connection,
so a handler that leaves its writer open after EOF hangs the teardown.
"""

import asyncio
import json

# Each scenario's own time limit, seconds: a hang fails the test instead
# of stalling the run.
LIMIT_S = 30.0


def run(coro, limit_s: float = LIMIT_S):
    """Run one scenario under its time limit."""
    return asyncio.run(asyncio.wait_for(coro, limit_s))


async def write_line(writer, obj):
    writer.write((json.dumps(obj) + "\n").encode())
    await writer.drain()


async def answer_sweep(payload, writer):
    """A deterministic answer derived from the request: two replicas
    given the same sweep produce bit-identical responses, which is the
    property the duplicate audit leans on."""
    return {"ok": True, "id": payload["id"],
            "result": {"echo": payload.get("conditions")},
            "quarantine": {"n_quarantined": 0}, "lanes": None}


async def drop_connection(payload, writer):
    writer.close()
    return None


async def stay_silent(payload, writer):
    return None


class StubReplica:
    """A wire-compatible replica: answers ``ping`` itself and routes
    ``sweep`` through a swappable ``behavior(payload, writer)``
    coroutine returning the response dict (or None to stay silent)."""

    def __init__(self, behavior=None, answer_ping=True):
        self.behavior = behavior or answer_sweep
        self.answer_ping = answer_ping
        self.up = True          # FakeSupervisor routability flag
        self.port = None
        self.sweeps_seen = 0
        self.bad_lines = 0
        self._server = None
        self._tasks = set()
        self._writers = set()

    async def start(self):
        self._server = await asyncio.start_server(
            self._on_conn, "127.0.0.1", 0)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self):
        self._server.close()
        for w in list(self._writers):
            w.close()
        for task in list(self._tasks):
            task.cancel()
        if self._tasks:
            await asyncio.gather(*list(self._tasks),
                                 return_exceptions=True)
        await self._server.wait_closed()

    async def _handle_sweep(self, payload, writer):
        # Concurrent handling, as the real server does: the protocol is
        # id-multiplexed, so responses may come back out of order.
        try:
            resp = await self.behavior(payload, writer)
            if resp is not None:
                await write_line(writer, resp)
        except (ConnectionError, OSError):
            pass

    async def _on_conn(self, reader, writer):
        self._writers.add(writer)
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                try:
                    payload = json.loads(line)
                except ValueError:
                    self.bad_lines += 1
                    continue
                if payload.get("op") == "ping":
                    if self.answer_ping:
                        await write_line(writer, {
                            "ok": True, "pong": True,
                            "id": payload.get("id")})
                    continue
                self.sweeps_seen += 1
                task = asyncio.ensure_future(
                    self._handle_sweep(payload, writer))
                self._tasks.add(task)
                task.add_done_callback(self._tasks.discard)
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self._writers.discard(writer)
            try:
                writer.close()
            except (ConnectionError, OSError):
                pass


class FakeSupervisor:
    """The supervisor surface the router consumes: ``endpoints()``,
    ``stats()`` and routability-change listeners."""

    def __init__(self, replicas):
        self.replicas = list(replicas)
        self._listeners = []

    def add_listener(self, fn):
        self._listeners.append(fn)

    def endpoints(self):
        return [{"idx": i, "incarnation": 1, "host": "127.0.0.1",
                 "port": s.port}
                for i, s in enumerate(self.replicas)
                if s.up and s.port is not None]

    def stats(self):
        return {"n_replicas": len(self.replicas),
                "up": sum(s.up for s in self.replicas), "replicas": []}

    def notify(self, event, idx):
        for fn in list(self._listeners):
            fn({"event": event, "idx": idx, "incarnation": 1,
                "host": "127.0.0.1",
                "port": self.replicas[idx].port})


# The fast router settings of the JAX package's router tests.
FAST_ROUTER = dict(max_inflight=16, breaker_fails=2,
                   breaker_cooldown_s=0.05, hedge_quantile=0.95,
                   hedge_min_s=0.02, retries=3, retry_base_delay_s=0.001,
                   retry_max_delay_s=0.01, connect_timeout_s=1.0,
                   probe_timeout_s=1.0, tick_s=0.005)
