"""The port's fleet tier (``pycatkin_tpu_torch.serve.{router,fleet}``) on
the CPU: the cases of the JAX package's ``tests/test_router.py``, and the
port held against the JAX package's router.

No solver runs here: the router moves bytes only, so it is tested
against stub TCP replicas (``torch_serve_stubs.py``), and the supervisor
against a tiny subprocess stub (``FleetConfig.command``) that boots in
milliseconds. Smallest first: the retry taxonomy classifies asyncio and
socket failures; the TCP client turns a stalled server into a structured
``E_TIMEOUT`` and a torn stream into a fast failure; the supervisor
registers replicas, classifies exits, restarts on backoff, demotes
stalled replicas and abandons crash loops; the router fails over without
loss, opens / probes / closes breakers, hedges interactive requests with
a bitwise duplicate audit, enacts the connection-level chaos kinds, and
answers every accepted request even when drain races a replica death.

Against the JAX package: the same breaker event sequence gives the same
state sequence in both ``CircuitBreaker`` classes; ``_canonical`` and
``canonical_answer`` agree on the same responses; and one stub scenario
(failover, then a torn line) gives the same client-visible responses
through both routers.

Every scenario runs under its own time limit
(``torch_serve_stubs.run``), and every stub closes its connections when
it stops.
"""

import asyncio
import json
import sys
import textwrap
import time

import pytest

from pycatkin_tpu.robustness import faults as jfaults
from pycatkin_tpu.serve import router as jrouter
from pycatkin_tpu.serve.protocol import canonical_answer as jcanonical
from pycatkin_tpu_torch.robustness import faults
from pycatkin_tpu_torch.serve import client as serve_client
from pycatkin_tpu_torch.serve import router as prouter
from pycatkin_tpu_torch.serve.client import TcpSweepClient, sweep_payload
from pycatkin_tpu_torch.serve.fleet import FleetConfig, ReplicaSupervisor
from pycatkin_tpu_torch.serve.protocol import (E_CONN_LOST, E_DRAINING,
                                               E_INTERNAL, E_OVERLOADED,
                                               E_TIMEOUT, canonical_answer,
                                               request_timeout_for,
                                               request_timeouts)
from pycatkin_tpu_torch.serve.router import (CircuitBreaker, RouterConfig,
                                             SweepRouter, _canonical)
from pycatkin_tpu_torch.utils import retry
from torch_serve_stubs import (FAST_ROUTER, FakeSupervisor, StubReplica,
                               answer_sweep, drop_connection, run,
                               stay_silent)

# Small per-class budgets, so that retry exhaustion is fast.
SHORT = {"standard": 2.0, "interactive": 1.5}


def fast_router_config(**overrides):
    kw = dict(FAST_ROUTER, timeouts=SHORT)
    kw.update(overrides)
    return RouterConfig(**kw)


async def _router_over(replicas, **cfg_overrides):
    for r in replicas:
        await r.start()
    sup = FakeSupervisor(replicas)
    router = await SweepRouter(
        sup, fast_router_config(**cfg_overrides)).start(listen=False)
    return sup, router


async def _teardown(router, replicas):
    await router.stop()
    for r in replicas:
        await r.stop()


def _sweep(i=0, deadline_class="standard"):
    return sweep_payload({"mech": "stub"}, [500.0 + i],
                         deadline_class=deadline_class, req_id=f"r{i}")


async def _wait_for(cond, timeout_s=20.0, what="condition"):
    deadline = asyncio.get_running_loop().time() + timeout_s
    while not cond():
        assert asyncio.get_running_loop().time() < deadline, \
            f"timed out waiting for {what}"
        await asyncio.sleep(0.02)


# -- the retry taxonomy and the settings -------------------------------


@pytest.mark.parametrize("exc", [
    ConnectionResetError("peer reset"),
    ConnectionRefusedError("nobody listening"),
    ConnectionAbortedError("aborted"),
    BrokenPipeError("write to dead peer"),
    asyncio.IncompleteReadError(b"partial", 64),
    asyncio.TimeoutError(),
    TimeoutError("deadline burned"),
    ValueError("connection reset"),      # marker text is not enough
    KeyError("port"),
    RuntimeError("shape mismatch"),
], ids=lambda e: type(e).__name__)
def test_retry_taxonomy_is_the_jax_packages(exc):
    from pycatkin_tpu.utils import retry as jretry
    assert retry.is_transient_backend_error(exc) \
        == jretry.is_transient_backend_error(exc)
    assert retry.is_transient_backend_error(exc) == isinstance(
        exc, (ConnectionError, asyncio.IncompleteReadError, TimeoutError))


def test_request_timeouts_are_keywords_with_the_jax_defaults():
    assert request_timeouts() == {"interactive": 30.0, "standard": 120.0,
                                  "batch": 600.0}
    assert request_timeout_for("batch", {"batch": 7.5}) == 7.5
    assert request_timeout_for("interactive", {"batch": 7.5}) == 30.0
    # Unknown classes fall back to the standard budget, the overridden
    # one if given.
    assert request_timeout_for("nonsense", {"standard": 3.0}) == 3.0
    with pytest.raises(ValueError, match="deadline class"):
        request_timeouts({"urgent": 1.0})
    cfg = RouterConfig()
    assert (cfg.max_inflight, cfg.breaker_fails, cfg.breaker_cooldown_s,
            cfg.hedge_quantile, cfg.hedge_min_s, cfg.retries,
            cfg.replay_concurrency) == (64, 3, 1.0, 0.95, 0.05, 3, 4)
    assert cfg.timeouts == request_timeouts()
    assert RouterConfig(timeouts={"batch": 9.0}).timeouts["batch"] == 9.0
    fc = FleetConfig()
    assert (fc.n_replicas, fc.max_restarts, fc.ping_period_s,
            fc.ping_misses) == (3, 5, 0.5, 3)
    assert FleetConfig(role="router").n_replicas == 1
    # No AOT pack to name: a replica on the card loads its kernel
    # library before it serves.
    with pytest.raises(TypeError, match="aot_pack"):
        FleetConfig(aot_pack="pack.tar.gz")


# -- TCP client deadlines and torn lines -------------------------------


def test_client_timeout_is_structured():
    async def scenario():
        stub = await StubReplica(behavior=stay_silent).start()
        cli = await TcpSweepClient("127.0.0.1", stub.port).connect()
        fast = await TcpSweepClient("127.0.0.1", stub.port,
                                    timeouts={"interactive": 0.05}
                                    ).connect()
        try:
            resp = await cli.request(_sweep(0), timeout=0.1)
            assert resp["ok"] is False
            assert resp["error"]["code"] == E_TIMEOUT
            assert resp["id"] == "r0"
            # The client's per-class budget applies when no explicit
            # timeout is passed.
            resp = await fast.request(_sweep(1,
                                             deadline_class="interactive"))
            assert resp["error"]["code"] == E_TIMEOUT
            assert "interactive" in resp["error"]["message"]
        finally:
            await cli.close()
            await fast.close()
            await stub.stop()
    run(scenario())


def test_client_counts_torn_final_line():
    async def behavior(payload, writer):
        writer.write(b'{"id": "r0", "ok": true, "resu\n')  # torn
        await writer.drain()
        writer.close()
        return None

    async def scenario():
        stub = await StubReplica(behavior=behavior).start()
        cli = await TcpSweepClient("127.0.0.1", stub.port).connect()
        try:
            resp = await cli.request(_sweep(0), timeout=5.0)
            # The torn line is counted and the dropped connection fails
            # the keyless pending request with a structured
            # connection-loss error instead of hanging it.
            assert cli.torn_lines == 1
            assert resp["ok"] is False
            assert resp["error"]["code"] == E_CONN_LOST
            assert resp["error"]["idempotency_key"] is False
            assert str(stub.port) in resp["error"]["peer"]
        finally:
            await cli.close()
            await stub.stop()
    run(scenario())


def test_client_fails_fast_after_torn_streak():
    async def behavior(payload, writer):
        for _ in range(serve_client.TORN_LINE_LIMIT):
            writer.write(b"%% not json %%\n")
        await writer.drain()
        return None            # then stall: the streak must break us

    async def scenario():
        stub = await StubReplica(behavior=behavior).start()
        cli = await TcpSweepClient("127.0.0.1", stub.port).connect()
        try:
            resp = await cli.request(_sweep(0), timeout=20.0)
            assert resp["ok"] is False
            assert "torn" in resp["error"]["message"]
            assert cli.torn_lines == serve_client.TORN_LINE_LIMIT
        finally:
            await cli.close()
            await stub.stop()
    run(scenario())


# -- the circuit breaker -----------------------------------------------


def test_breaker_lifecycle():
    br = CircuitBreaker(fails=2, cooldown_s=0.01)
    assert br.routable
    br.record_failure()
    assert br.routable            # below threshold
    br.record_failure()
    assert br.state == "open" and not br.routable
    assert not br.probe_due()     # cooldown not burned yet
    time.sleep(0.02)
    assert br.probe_due()
    br.begin_probe()
    assert br.state == "half-open"
    br.probe_result(False)
    assert br.state == "open"
    time.sleep(0.02)
    br.begin_probe()
    br.probe_result(True)
    assert br.state == "closed" and br.failures == 0
    # One failure in half-open reopens at once (no threshold).
    br.record_failure()
    br.record_failure()
    time.sleep(0.02)
    br.begin_probe()
    br.record_failure()
    assert br.state == "open"


# The events of a breaker's life, each a method name (with its argument)
# and the delay slept before it.
BREAKER_SCRIPT = (
    ("record_failure",), ("record_success",), ("record_failure",),
    ("record_failure",), ("record_failure",), ("probe_due",),
    ("sleep",), ("probe_due",), ("begin_probe",), ("probe_result", False),
    ("probe_due",), ("sleep",), ("begin_probe",), ("record_failure",),
    ("sleep",), ("begin_probe",), ("probe_result", True),
    ("force_open",), ("sleep",), ("probe_due",), ("begin_probe",),
    ("record_success",), ("record_failure",), ("record_failure",),
    ("record_failure",))


def _breaker_trace(cls):
    br = cls(fails=3, cooldown_s=0.01)
    trace = []
    for step in BREAKER_SCRIPT:
        if step[0] == "sleep":
            time.sleep(0.015)
            continue
        out = getattr(br, step[0])(*step[1:])
        trace.append((step[0], out, br.state, br.failures, br.probing,
                      br.routable))
    return trace


def test_breaker_state_sequence_is_the_jax_packages():
    assert _breaker_trace(CircuitBreaker) == \
        _breaker_trace(jrouter.CircuitBreaker)


# -- the canonical form ------------------------------------------------


CANONICAL_CASES = [
    {"ok": True, "result": {"x": 1}, "quarantine": None, "lanes": None,
     "timing": {"total_s": 0.5}, "pack": {"k": 2}},
    {"ok": True, "result": {"x": 1}, "quarantine": None, "lanes": None,
     "timing": {"total_s": 9.9}, "pack": {"k": 4}, "id": "q7"},
    {"ok": True, "result": {"x": 2}, "quarantine": None, "lanes": None},
    {"ok": True, "result": {"success": [True, False], "residual":
     [1e-12, "nan"], "tof": [0.1, -2.5e-300]},
     "quarantine": {"n_quarantined": 1, "lanes": [1]}, "lanes": 2},
    {"ok": False, "error": {"code": "timeout", "message": "slow"}},
    {},
]


def test_canonical_ignores_metadata():
    a, b, c = CANONICAL_CASES[:3]
    assert _canonical(a) == _canonical(b)
    assert _canonical(a) != _canonical(c)


@pytest.mark.parametrize("resp", CANONICAL_CASES,
                         ids=[f"case{i}" for i in range(len(CANONICAL_CASES))])
def test_canonical_is_the_jax_packages(resp):
    assert _canonical(resp) == canonical_answer(resp) == jcanonical(resp) \
        == jrouter._canonical(resp)


# -- the router: routing, failover, admission --------------------------


def test_router_answers_and_hides_internals():
    async def scenario():
        replicas = [StubReplica(), StubReplica()]
        sup, router = await _router_over(replicas)
        try:
            resp = await router.handle(_sweep(0))
            assert resp["ok"] and resp["id"] == "r0"
            assert "_replica_idx" not in resp
            st = router.stats()
            assert st["ok_total"] == 1 and st["availability"] == 1.0
            assert st["durable"] is None
        finally:
            await _teardown(router, replicas)
    run(scenario())


def test_router_fails_over_losslessly():
    async def scenario():
        dead = StubReplica(behavior=drop_connection)
        live = StubReplica()
        sup, router = await _router_over([dead, live])
        try:
            resps = await asyncio.gather(*(
                router.handle(_sweep(i)) for i in range(6)))
            assert all(r["ok"] for r in resps)
            st = router.stats()
            assert st["failovers"] >= 1
            assert st["retries"] >= 1
            assert st["availability"] == 1.0
            assert st["failover_p99_s"] is not None
        finally:
            await _teardown(router, replicas=[dead, live])
    run(scenario())


def test_router_overload_then_breaker_recovery():
    async def scenario():
        replicas = [StubReplica(behavior=drop_connection),
                    StubReplica(behavior=drop_connection)]
        sup, router = await _router_over(replicas)
        try:
            resp = await router.handle(_sweep(0))
            assert resp["ok"] is False
            assert resp["error"]["code"] == E_INTERNAL
            # Both breakers are open now: admission rejects with a
            # structured overload, not a hang.
            resp = await router.handle(_sweep(1))
            assert resp["error"]["code"] == E_OVERLOADED
            assert set(router.stats()["breakers"].values()) == {"open"}
            # The replicas recover; the admission path itself kicks the
            # half-open probes, so the router rediscovers them even
            # while rejecting everything.
            for r in replicas:
                r.behavior = answer_sweep
            deadline = asyncio.get_running_loop().time() + 5.0
            while True:
                resp = await router.handle(_sweep(2))
                if resp.get("ok"):
                    break
                assert asyncio.get_running_loop().time() < deadline, \
                    f"router never recovered: {router.stats()}"
                await asyncio.sleep(0.02)
        finally:
            await _teardown(router, replicas)
    run(scenario())


def test_router_hedges_interactive_and_audits_duplicates():
    async def slow_answer(payload, writer):
        await asyncio.sleep(0.3)
        return await answer_sweep(payload, writer)

    async def scenario():
        slow = StubReplica(behavior=slow_answer)
        fast = StubReplica()
        sup, router = await _router_over([slow, fast])
        try:
            resp = await router.handle(
                _sweep(0, deadline_class="interactive"))
            assert resp["ok"]
            assert router.stats()["hedges"] >= 1
            # The loser's late answer is suppressed and audited as
            # bit-identical (deterministic same-width sweeps).
            await _wait_for(
                lambda: router.stats()["duplicates"]["suppressed"] >= 1,
                timeout_s=2.0, what="the suppressed duplicate")
            dup = router.stats()["duplicates"]
            assert dup["mismatched"] == 0
            assert dup["identical"] >= 1
        finally:
            await _teardown(router, replicas=[slow, fast])
    run(scenario())


def test_router_inflight_cap_rejects_structured():
    async def scenario():
        slow = StubReplica(behavior=stay_silent)
        sup, router = await _router_over([slow], max_inflight=1,
                                         retries=0)
        try:
            first = asyncio.ensure_future(router.handle(_sweep(0)))
            await asyncio.sleep(0.05)      # let it occupy the slot
            resp = await router.handle(_sweep(1))
            assert resp["error"]["code"] == E_OVERLOADED
            assert "in-flight cap" in resp["error"]["message"]
            first.cancel()
            try:
                await first
            except asyncio.CancelledError:
                pass
        finally:
            await _teardown(router, replicas=[slow])
    run(scenario())


def test_router_budget_comes_from_its_timeouts():
    async def scenario():
        slow = StubReplica(behavior=stay_silent)
        sup, router = await _router_over([slow], retries=0,
                                         timeouts={"standard": 0.2})
        try:
            t0 = time.monotonic()
            resp = await router.handle(_sweep(0))
            assert resp["error"]["code"] in (E_TIMEOUT, E_INTERNAL)
            assert time.monotonic() - t0 < 5.0
        finally:
            await _teardown(router, replicas=[slow])
    run(scenario())


# -- the router: connection-level chaos kinds --------------------------


def test_conn_reset_chaos_fails_over():
    async def scenario():
        replicas = [StubReplica(), StubReplica()]
        sup, router = await _router_over(replicas)
        plan = faults.FaultPlan([{"site": "router:dispatch:*",
                                  "kind": "conn-reset", "times": 1}])
        try:
            with faults.fault_scope(plan):
                resp = await router.handle(_sweep(0))
            assert resp["ok"]
            assert [e["kind"] for e in plan.log] == ["conn-reset"]
            assert router.stats()["retries"] >= 1
        finally:
            await _teardown(router, replicas)
    run(scenario())


def test_torn_line_chaos_recovers_under_budget():
    async def scenario():
        replicas = [StubReplica(), StubReplica()]
        sup, router = await _router_over(replicas)
        plan = faults.FaultPlan([{"site": "router:dispatch:*",
                                  "kind": "torn-line", "times": 1}])
        try:
            with faults.fault_scope(plan):
                resp = await router.handle(_sweep(0))
            assert resp["ok"]
            assert [e["kind"] for e in plan.log] == ["torn-line"]
            # The replica saw one undecodable line (the torn write) and
            # the router's retry answered the request anyway.
            assert sum(r.bad_lines for r in replicas) == 1
        finally:
            await _teardown(router, replicas)
    run(scenario())


# -- the router: drain during failover ---------------------------------


def test_drain_during_failover_answers_every_accepted():
    async def slowish(payload, writer):
        await asyncio.sleep(0.15)
        return await answer_sweep(payload, writer)

    async def scenario():
        doomed = StubReplica(behavior=slowish)
        live = StubReplica(behavior=slowish)
        sup, router = await _router_over([doomed, live])
        try:
            accepted = [asyncio.ensure_future(
                router.handle(_sweep(i))) for i in range(6)]
            await asyncio.sleep(0.05)      # all dispatched, none done
            drainer = asyncio.ensure_future(router.drain())
            # Replica 0 dies mid-drain: its in-flight dispatches must
            # fail over to the survivor, not be dropped.
            doomed.up = False
            sup.notify("down", 0)
            await doomed.stop()
            resps = await asyncio.gather(*accepted)
            await drainer
            assert all(r["ok"] for r in resps), resps
            assert router.stats()["failovers"] >= 1
            # Admission after the drain is a structured reject.
            resp = await router.handle(_sweep(99))
            assert resp["error"]["code"] == E_DRAINING
        finally:
            await router.stop()
            await live.stop()
    run(scenario())


# -- the port's router against the JAX package's -----------------------


def _scenario_through(router_mod, faults_mod, **cfg):
    """Failover (replica 0 drops every connection), then a torn line,
    through ``router_mod``'s router; the client-visible responses and
    the bad lines the replicas saw."""
    async def scenario():
        dead = StubReplica(behavior=drop_connection)
        live = StubReplica()
        for r in (dead, live):
            await r.start()
        router = await router_mod.SweepRouter(
            FakeSupervisor([dead, live]),
            router_mod.RouterConfig(**FAST_ROUTER, **cfg)).start(
                listen=False)
        try:
            out = [await router.handle(_sweep(i)) for i in range(4)]
            plan = faults_mod.FaultPlan([{"site": "router:dispatch:*",
                                          "kind": "torn-line",
                                          "times": 1}])
            with faults_mod.fault_scope(plan):
                out.append(await router.handle(_sweep(4)))
            out.append(await router.handle(
                _sweep(5, deadline_class="interactive")))
            out.append(await router.handle({"op": "bogus", "id": "b"}))
            out.append(await router.handle({"op": "result", "key": "k",
                                            "id": "f"}))
            st = router.stats()
            return ([json.dumps(r, sort_keys=True) for r in out],
                    [e["kind"] for e in plan.log],
                    live.bad_lines + dead.bad_lines, st["availability"],
                    st["ok_total"])
        finally:
            await router.stop()
            await dead.stop()
            await live.stop()
    return run(scenario())


def test_stub_scenario_is_the_jax_routers(monkeypatch):
    # The same short budgets in both: the port's are a keyword, the JAX
    # router's come from its module's request_timeout_for.
    monkeypatch.setattr(jrouter, "request_timeout_for",
                        lambda cls: request_timeout_for(cls, SHORT))
    port = _scenario_through(prouter, faults, timeouts=SHORT)
    jax = _scenario_through(jrouter, jfaults)
    assert port == jax
    assert all(json.loads(r)["ok"] for r in port[0][:6])
    assert port[1] == ["torn-line"] and port[2] == 1


# -- the fleet supervisor over a stub subprocess -----------------------


STUB_REPLICA = textwrap.dedent("""
    import json, socket, sys, threading

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(16)
    print(json.dumps({"serving": True, "host": "127.0.0.1",
                      "port": srv.getsockname()[1]}), flush=True)

    def serve(conn):
        f = conn.makefile("rwb")
        for line in f:
            try:
                req = json.loads(line)
            except ValueError:
                continue
            f.write((json.dumps({"ok": True, "pong": True,
                                 "id": req.get("id")}) + "\\n")
                    .encode())
            f.flush()

    while True:
        conn, _ = srv.accept()
        threading.Thread(target=serve, args=(conn,),
                         daemon=True).start()
""")


@pytest.fixture
def stub_command(tmp_path):
    path = tmp_path / "stub_replica.py"
    path.write_text(STUB_REPLICA)
    return [sys.executable, str(path)]


def fast_fleet_config(command, **overrides):
    kw = dict(n_replicas=2, command=command,
              restart_base_delay_s=0.01, restart_max_delay_s=0.1,
              ping_period_s=0.1, ping_misses=2, ping_timeout_s=1.0,
              boot_timeout_s=20.0, stop_grace_s=5.0, tick_s=0.01)
    kw.update(overrides)
    return FleetConfig(**kw)


def test_supervisor_boots_registers_and_restarts(stub_command, tmp_path):
    endpoints = str(tmp_path / "endpoints.json")

    async def scenario():
        events = []
        sup = ReplicaSupervisor(fast_fleet_config(
            stub_command, endpoints_file=endpoints))
        sup.add_listener(events.append)
        await sup.start()
        try:
            eps = sup.endpoints()
            assert len(eps) == 2
            assert all(e["incarnation"] == 1 for e in eps)
            assert [e["event"] for e in events] == ["up", "up"]
            # The endpoints file is the routable set, written atomically.
            with open(endpoints) as fh:
                assert json.load(fh)["endpoints"] == eps
            # SIGKILL replica 0: classified signal-death (transient),
            # restarted on backoff as a new incarnation on a new port.
            old_port = sup.replicas[0].port
            sup.replicas[0].proc.kill()
            await _wait_for(
                lambda: sup.replicas[0].incarnation == 2
                and sup.replicas[0].routable,
                what="replica 0 reboot")
            assert sup.replicas[0].last_exit_kind == "signal-death"
            assert sup.replicas[0].restarts == 1
            assert sup.replicas[0].port != old_port
            assert [e["event"] for e in events] == ["up", "up", "down",
                                                    "up"]
        finally:
            await sup.stop()
        assert all(r.proc is None or r.proc.returncode is not None
                   for r in sup.replicas)
    run(scenario())


def test_supervisor_enacts_chaos_kill_at_its_site(stub_command):
    async def scenario():
        sup = ReplicaSupervisor(fast_fleet_config(stub_command,
                                                  n_replicas=1))
        await sup.start()
        plan = faults.FaultPlan([{"site": "router:replica:0",
                                  "kind": "replica-crash",
                                  "times": 1}])
        try:
            with faults.fault_scope(plan):
                await _wait_for(
                    lambda: sup.replicas[0].incarnation == 2
                    and sup.replicas[0].routable,
                    what="chaos kill + reboot")
            assert [e["kind"] for e in plan.log] == ["replica-crash"]
            assert sup.replicas[0].last_exit_kind == "signal-death"
        finally:
            await sup.stop()
    run(scenario())


def test_supervisor_demotes_stalled_replica_then_reboots(stub_command):
    async def scenario():
        events = []
        sup = ReplicaSupervisor(fast_fleet_config(stub_command,
                                                  n_replicas=1))
        sup.add_listener(events.append)
        await sup.start()
        plan = faults.FaultPlan([{"site": "router:replica:0",
                                  "kind": "replica-stall",
                                  "times": 1}])
        try:
            # SIGSTOP (the replica-stall kind): alive but silent. Missed
            # pings demote it (unroutable, announced), twice the miss
            # budget kills it, and the exit path reboots a fresh
            # incarnation.
            with faults.fault_scope(plan):
                await _wait_for(
                    lambda: any(e["event"] == "down" for e in events),
                    what="demotion")
            assert sup.endpoints() == []
            await _wait_for(
                lambda: sup.replicas[0].incarnation == 2
                and sup.replicas[0].routable,
                what="stall kill + reboot")
            assert [e["kind"] for e in plan.log] == ["replica-stall"]
            assert sup.replicas[0].last_exit_kind == "signal-death"
        finally:
            await sup.stop()
    run(scenario())


def test_supervisor_abandons_crash_loops(tmp_path):
    bad = tmp_path / "crash.py"
    bad.write_text("import sys; sys.exit(3)\n")

    async def scenario():
        events = []
        sup = ReplicaSupervisor(fast_fleet_config(
            [sys.executable, str(bad)], n_replicas=1, max_restarts=1,
            restart_max_delay_s=0.02))
        sup.add_listener(events.append)
        with pytest.raises(RuntimeError, match="no replica came up"):
            await sup.start()
        try:
            assert sup.replicas[0].state == "abandoned"
            assert sup.replicas[0].last_exit_kind == "nonzero-exit"
            assert events[-1]["event"] == "abandoned"
        finally:
            await sup.stop()
    run(scenario())
