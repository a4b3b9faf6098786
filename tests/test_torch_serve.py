"""The port's sweep server (``pycatkin_tpu_torch.serve``) on the CPU
against the JAX package's serving layer.

- Protocol: ``parse_sweep_request`` / ``parse_transient_request`` equal
  the JAX package's on valid payloads, and on the bad payloads of its
  ``tests/test_serve.py`` raise the same error code naming the same
  field; ``ServeConfig()`` resolves to the JAX package's defaults (no
  environment variable set).
- Server, in process, ``device="cpu"``, bucket 16, 2 lanes: two
  same-bucket sweeps ride one packed flush, each ``result`` byte for
  byte the ``jsonable`` of its solo ``sweep_steady_state(abi=True)``;
  transients coalesce by grid and never with a sweep; the admission
  rejects carry the JAX server's codes; a TCP round trip followed by a
  drain loses nothing.
- Across packages: the JAX package's ``TcpSweepClient`` talks to the
  port's server; a mechanism sent as the JAX package's
  ``system_to_dict`` is answered as the port's own; both servers build
  the same response from the same solver output (keys and bytes); and
  one sweep answered by both servers' own solvers (the JAX server
  compiles its programs, ~7 s) has the same verdicts bitwise and
  residual, TOF and activity in the envelope.

The mechanisms are ``synthetic_system_for_bucket(16, seed)`` of seeds 1
and 4, whose transients take ~36 steps on the CPU (seed 0's takes
~2,000, which the plain LU versions make minutes).
"""

import asyncio
import json
import os

import numpy as np
import pytest
import torch

from pycatkin_tpu.serve import protocol as jprotocol
from pycatkin_tpu_torch import engine
from pycatkin_tpu_torch.models.synthetic import synthetic_system_for_bucket
from pycatkin_tpu_torch.parallel import batch
from pycatkin_tpu_torch.serve import (ServeConfig, ServeError, SweepClient,
                                      SweepServer, TcpSweepClient)
from pycatkin_tpu_torch.serve import protocol
from pycatkin_tpu_torch.serve.client import sweep_payload
from pycatkin_tpu_torch.serve.protocol import (E_BAD_REQUEST, E_DRAINING,
                                               E_OVERLOADED, canonical_answer,
                                               jsonable)
from pycatkin_tpu_torch.serve.server import SUMMARY_KEYS
from pycatkin_tpu_torch.utils.io import system_to_dict

N_LANES = 2
T_GRID = [500.0, 520.0]
SAVE_TS = [0.0, 1e-7, 1e-5, 1e-3]
SEEDS = (1, 4)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sims():
    return [synthetic_system_for_bucket(16, seed=s, device="cpu")
            for s in SEEDS]


def _server(**kw):
    return SweepServer(ServeConfig(device="cpu", **kw))


def _solo_result(sim, T=T_GRID, tof_terms=None, want=()):
    """The ``result`` a served sweep of ``sim`` must carry: its solo
    ``sweep_steady_state(abi=True)`` summary, as JSON."""
    conds = batch.stack_conditions([sim.conditions(T=t, p=1e5) for t in T])
    mask = engine.tof_mask_for(sim.spec, tof_terms) if tof_terms else None
    out = batch.sweep_steady_state(sim.spec, conds, mask, abi=True,
                                   device="cpu")
    keys = [k for k in SUMMARY_KEYS if k in out] + list(want)
    return jsonable({k: out[k].numpy() for k in keys})


# -- protocol ----------------------------------------------------------


BAD_SWEEPS = [
    ({}, "/mechanism"),
    ({"mechanism": {}}, "/conditions"),
    ({"mechanism": {}, "conditions": {}}, "/conditions/T"),
    ({"mechanism": {}, "conditions": {"T": []}}, "/conditions/T"),
    ({"mechanism": {}, "conditions": {"T": [1, 2], "p": [1]}},
     "/conditions/p"),
    ({"mechanism": {}, "conditions": {"T": 500}, "tof_terms": "r1"},
     "/tof_terms"),
    ({"mechanism": {}, "conditions": {"T": 500}, "wait_budget_s": -1},
     "/wait_budget_s"),
    ({"mechanism": {}, "conditions": {"T": 500}, "return": "y"},
     "/return"),
    ({"mechanism": {}, "conditions": {"T": 500}, "idempotency_key": ""},
     "/idempotency_key"),
]
_BASE = {"mechanism": {}, "conditions": {"T": 500}}
BAD_TRANSIENTS = [
    (dict(_BASE), "/save_ts"),
    (dict(_BASE, save_ts=[0.0]), "/save_ts"),
    (dict(_BASE, save_ts=[1e-6, 1e-3]), "/save_ts"),
    (dict(_BASE, save_ts=[0.0, 1e-3, 1e-6]), "/save_ts"),
    (dict(_BASE, save_ts=[0.0, float("nan")]), "/save_ts"),
    (dict(_BASE, save_ts="soon"), "/save_ts"),
]


@pytest.mark.parametrize("parse, cases", [
    ("parse_sweep_request", BAD_SWEEPS),
    ("parse_transient_request", BAD_TRANSIENTS)], ids=["sweep", "transient"])
def test_bad_payloads_raise_the_jax_codes_naming_the_field(parse, cases):
    for payload, field in cases:
        for mod in (protocol, jprotocol):
            with pytest.raises(mod.ServeError) as exc:
                getattr(mod, parse)(payload)
            assert exc.value.code == E_BAD_REQUEST
            assert field in str(exc.value), (mod.__name__, payload)


def test_valid_payloads_parse_as_in_the_jax_package():
    payloads = [
        {"mechanism": {}, "conditions": {"T": 500}},
        {"mechanism": {"x": 1}, "conditions": {"T": [500, 550], "p": 2e5},
         "tof_terms": ["r1"], "deadline_class": "batch",
         "wait_budget_s": 0.5, "return": ["y"], "idempotency_key": "k"},
        {"mechanism": {}, "conditions": {"T": [450.0], "p": [1e5]},
         "deadline_class": "interactive"},
    ]
    for payload in payloads:
        assert protocol.parse_sweep_request(payload) == \
            jprotocol.parse_sweep_request(payload)
        tr = dict(payload, save_ts=SAVE_TS)
        assert protocol.parse_transient_request(tr) == \
            jprotocol.parse_transient_request(tr)
    parsed = protocol.parse_sweep_request(payloads[0])
    assert parsed["T"] == [500.0] and parsed["p"] == [1.0e5]


def test_serve_config_resolves_to_the_jax_defaults(monkeypatch):
    for key in (jprotocol.HOST_ENV, jprotocol.PORT_ENV,
                jprotocol.MAX_PENDING_ENV, jprotocol.RUNNER_ENV,
                jprotocol.AOT_PACK_ENV, *jprotocol._BUDGET_ENVS.values(),
                *jprotocol._TIMEOUT_ENVS.values()):
        monkeypatch.delenv(key, raising=False)
    ours, theirs = ServeConfig(), jprotocol.ServeConfig()
    for f in ("host", "port", "max_pending", "runner", "aot_pack",
              "work_dir", "max_occupancy", "max_wait_s", "tick_s",
              "n_workers", "budgets"):
        assert getattr(ours, f) == getattr(theirs, f), f
    assert ours.device is None
    assert protocol.request_timeouts() == jprotocol.request_timeouts()
    assert protocol.DEADLINE_CLASSES == jprotocol.DEADLINE_CLASSES
    assert protocol.request_timeout_for("nope") == \
        jprotocol.request_timeout_for("nope")
    # The port reads no environment variable.
    monkeypatch.setenv("PYCATKIN_SERVE_MAX_PENDING", "7")
    assert ServeConfig().max_pending == 256
    with pytest.raises(ServeError) as exc:
        ours.wait_budget_for("realtime")
    assert exc.value.code == E_BAD_REQUEST
    with pytest.raises(ValueError, match="ROADMAP.md"):
        ServeConfig(aot_pack="pack.tar")
    # runner="elastic" builds the scheduler's runner for the coalescer.
    from pycatkin_tpu_torch.robustness import scheduler
    server = SweepServer(ServeConfig(runner="elastic", device="cpu"))
    runner = server._make_coalescer().runner
    assert runner.__qualname__ == scheduler.packed_group_runner(
    ).__qualname__
    assert os.path.isdir(server._own_work_dir)
    asyncio.run(server.stop())
    assert server._own_work_dir is None
    with pytest.raises(ValueError):
        ServeConfig(runner="bogus")
    with pytest.raises(ValueError):
        ServeConfig(max_pending=0)


def test_wire_helpers_match_the_jax_package():
    payload = {"ok": np.array([True, False]), "x": np.array([1.5, np.nan]),
               "n": np.int32(3), "t": torch.tensor([0.25, float("inf")])}
    ours = jsonable(payload)
    assert ours == {"ok": [True, False], "x": [1.5, "nan"], "n": 3,
                    "t": [0.25, "inf"]}
    assert ours["x"] == jprotocol.jsonable(payload["x"])
    resp = {"result": ours, "quarantine": {"count": 0, "lanes": []},
            "lanes": 2, "timing": {"total_s": 1.0}, "id": "a"}
    assert canonical_answer(resp) == jprotocol.canonical_answer(resp)
    assert protocol.error_response("a", "x", "m", peer="p") == \
        jprotocol.error_response("a", "x", "m", peer="p")
    assert protocol.accepted_ack(1, "k") == jprotocol.accepted_ack(1, "k")


def test_without_a_card_the_server_refuses_to_start(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(SweepServer(ServeConfig()).start(listen=False))
    from pycatkin_tpu_torch.serve.__main__ import main
    # The front router is ported: without the endpoints file of a fleet
    # to route to, it refuses with a usage error instead of raising.
    assert main(["--router"]) == 2


def test_stats_count_the_kernel_launches_since_start():
    # A fleet's replicas report their own launches: what the process
    # launched before start() is not the server's. The launch itself
    # needs the card, so the wrappers' counter is bumped directly.
    from pycatkin_tpu_torch.ops import cuda_linalg as cl

    async def scenario():
        cl._count("lu_factor", torch.float64, 16, 12)
        server = await _server().start(listen=False)
        try:
            assert server.stats()["launches"] == []
            cl._count("lu_factor", torch.float64, 16, 12)
            cl._count("lu_solve", torch.float32, 16, 3)
            cl._count("lu_solve", torch.float32, 16, 3)
            return server.stats()["launches"]
        finally:
            await server.stop()
    saved = [dict(c) for c in (cl.LAUNCHES, cl.LAUNCHES_F32,
                                cl.LAUNCHES_BY_SHAPE)]
    try:
        assert asyncio.run(scenario()) == [["lu_factor", 16, 12, 1],
                                           ["lu_solve_f32", 16, 3, 2]]
    finally:
        cl.reset_launches()
        for c, old in zip((cl.LAUNCHES, cl.LAUNCHES_F32,
                           cl.LAUNCHES_BY_SHAPE), saved):
            c.update(old)


# -- admission ---------------------------------------------------------


def test_admission_rejects_are_structured_responses():
    async def scenario():
        server = await _server().start(listen=False)
        try:
            pong = await SweepClient(server).ping()
            assert pong["ok"] and pong["pong"]
            bad = await server.handle({"op": "conjure", "id": 3})
            assert not bad["ok"] and bad["id"] == 3
            assert bad["error"]["code"] == E_BAD_REQUEST
            bad = await server.handle({"op": "sweep", "id": 4})
            assert bad["error"]["code"] == E_BAD_REQUEST
            assert "/mechanism" in bad["error"]["message"]
            bad = await server.handle({"op": "sweep", "id": 7,
                                       "mechanism": 5,
                                       "conditions": {"T": 500}})
            assert bad["error"]["code"] == E_BAD_REQUEST
            assert "/mechanism" in bad["error"]["message"]
            server.config.max_pending = 1
            server._taken = 5  # a deep in-flush backlog
            busy = await server.handle(
                {"op": "sweep", "id": 5, "mechanism": {},
                 "conditions": {"T": 500}})
            server._taken = 0
            assert busy["error"]["code"] == E_OVERLOADED
            server._draining = True
            no = await server.handle(
                {"op": "transient", "id": 6, "mechanism": {},
                 "conditions": {"T": 500}, "save_ts": SAVE_TS})
            server._draining = False
            assert no["error"]["code"] == E_DRAINING
            stats = (await SweepClient(server).stats())["stats"]
            assert stats["rejected_total"] == 5
            assert stats["requests_total"] == 4  # sweeps that got in
        finally:
            await server.stop()

    asyncio.run(scenario())


# -- round trips -------------------------------------------------------


def test_two_same_bucket_sweeps_ride_one_packed_flush(sims):
    async def scenario():
        server = await _server().start(listen=False)
        try:
            client = SweepClient(server)
            resps = await asyncio.gather(*(
                client.sweep(sim, T_GRID, tof_terms=[sim.spec.rnames[-1]],
                             wait_budget_s=5.0, want=["y"])
                for sim in sims))
            stats = server.stats()
        finally:
            await server.drain()
        return resps, stats

    from pycatkin_tpu_torch.utils import profiling
    profiling.reset_sync_count()
    resps, stats = asyncio.run(scenario())
    # The flush's results reach the host in one counted transfer.
    assert profiling.sync_labels().count("coalescer flush") == 1
    for sim, resp in zip(sims, resps):
        assert resp["ok"], resp.get("error")
        for field in ("result", "manifest", "lane_telemetry", "quarantine",
                      "pack", "timing"):
            assert field in resp
        assert resp["pack"]["tenants"] == 2 and resp["pack"]["k_bucket"] == 2
        assert resp["manifest"]["abi"]["packed"]
        assert resp["manifest"]["abi"]["fingerprint"] == \
            "abi-v1:s16:r16:d8:rt0:detailed_balance"
        assert resp["manifest"]["backend"]["platform"] == "cpu"
        want = _solo_result(sim, tof_terms=[sim.spec.rnames[-1]],
                            want=["y"])
        assert json.dumps(resp["result"]) == json.dumps(want)
        assert len(resp["lane_telemetry"]) == N_LANES
    assert resps[0]["pack"]["flush_seq"] == resps[1]["pack"]["flush_seq"]
    assert stats["flushes"] == 1 and stats["completed_total"] == 2
    assert stats["mean_occupancy"] == 1.0


def test_transients_coalesce_by_grid_and_never_with_a_sweep(sims):
    other = SAVE_TS[:3]

    async def scenario():
        server = await _server().start(listen=False)
        try:
            client = SweepClient(server)
            jobs = [client.transient(sim, T_GRID, SAVE_TS,
                                     wait_budget_s=5.0, want=["ys"])
                    for sim in sims]
            jobs.append(client.transient(sims[0], T_GRID, other,
                                         wait_budget_s=5.0))
            jobs.append(client.sweep(sims[1], T_GRID, wait_budget_s=5.0))
            return await asyncio.gather(*jobs), server.stats()
        finally:
            await server.drain()

    (a, b, c, d), stats = asyncio.run(scenario())
    for r in (a, b, c, d):
        assert r["ok"], r.get("error")
    assert a["pack"]["tenants"] == 2 and a["pack"]["flush_seq"] == \
        b["pack"]["flush_seq"]
    assert c["pack"]["tenants"] == 1 and d["pack"]["tenants"] == 1
    assert len({a["pack"]["flush_seq"], c["pack"]["flush_seq"],
                d["pack"]["flush_seq"]}) == 3
    assert stats["flushes"] == 3
    assert a["save_points"] == len(SAVE_TS) and c["save_points"] == 3
    for sim, r, ts in ((sims[0], a, SAVE_TS), (sims[1], b, SAVE_TS),
                       (sims[0], c, other)):
        conds = batch.stack_conditions([sim.conditions(T=t, p=1e5)
                                        for t in T_GRID])
        ys, ok = batch.batch_transient(sim.spec, conds, ts, abi=True,
                                       device="cpu")
        want = {"ok": ok.numpy(), "endpoint": ys[:, -1, :].numpy()}
        if "ys" in r["result"]:
            want["ys"] = ys.numpy()
        assert json.dumps(r["result"]) == json.dumps(jsonable(want))
        assert r["quarantine"] == {"count": 0, "lanes": []}
    assert json.dumps(d["result"]) == json.dumps(_solo_result(sims[1]))


def test_tcp_round_trip_then_drain_loses_nothing(sims):
    async def scenario():
        server = await _server(max_occupancy=4).start()
        tcp = await TcpSweepClient("127.0.0.1", server.port).connect()
        try:
            mechs = [system_to_dict(s) for s in sims]
            first = await tcp.sweep(mechs[0], T_GRID, wait_budget_s=0.0)
            burst = [asyncio.ensure_future(tcp.sweep(
                mechs[i % 2], T_GRID, wait_budget_s=0.2)) for i in range(5)]
            while server.stats()["completed_total"] + server.in_service \
                    < 6:
                await asyncio.sleep(0.002)
            drain = await tcp.drain()
            rest = await asyncio.gather(*burst)
            await server.wait_stopped()
            return first, drain, rest, server.stats()
        finally:
            await tcp.close()
            await server.stop()

    first, drain, rest, stats = asyncio.run(scenario())
    assert drain["ok"] and drain["draining"]
    assert all(r["ok"] for r in [first] + rest), [r.get("error")
                                                  for r in rest]
    assert stats["completed_total"] == 6 and stats["rejected_total"] == 0
    want = [_solo_result(s) for s in sims]
    assert json.dumps(first["result"]) == json.dumps(want[0])
    for i, r in enumerate(rest):
        assert json.dumps(r["result"]) == json.dumps(want[i % 2])


# -- across packages ---------------------------------------------------


def test_jax_client_and_jax_wire_form_against_the_port_server(sims):
    from pycatkin_tpu.models.synthetic import synthetic_system_for_bucket \
        as jbucket
    from pycatkin_tpu.serve.client import TcpSweepClient as JaxClient
    from pycatkin_tpu.utils.io import system_to_dict as jax_dict
    jmech = jax_dict(jbucket(16, seed=SEEDS[0]))

    async def scenario():
        server = await _server().start()
        try:
            client = await JaxClient("127.0.0.1", server.port).connect()
            try:
                pong = await client.ping()
                theirs = await client.sweep(jmech, T_GRID,
                                            wait_budget_s=0.0)
                ours = await client.sweep(system_to_dict(sims[0]), T_GRID,
                                          wait_budget_s=0.0)
                tr = await client.transient(jmech, T_GRID, SAVE_TS,
                                            wait_budget_s=0.0)
                stats = await client.stats()
            finally:
                await client.close()
        finally:
            await server.drain()
        return pong, theirs, ours, tr, stats

    pong, theirs, ours, tr, stats = asyncio.run(scenario())
    assert pong["protocol"] == jprotocol.PROTOCOL == protocol.PROTOCOL
    assert pong["ok"] and pong["pong"]
    assert theirs["ok"] and ours["ok"] and tr["ok"]
    assert canonical_answer(theirs) == canonical_answer(ours)
    assert json.dumps(ours["result"]) == json.dumps(_solo_result(sims[0]))
    assert stats["stats"]["completed_total"] == 3


def _jax_response(monkeypatch, payload, outs):
    """The JAX server's response to ``payload`` when its coalescer's
    runner returns ``outs`` (the port's solver output, numpy)."""
    from pycatkin_tpu.serve.server import SweepServer as JaxServer

    async def scenario():
        server = await JaxServer(jprotocol.ServeConfig()).start(
            listen=False)
        server._coalescer.runner = lambda sims, *a, **kw: outs
        try:
            return await server.handle(payload)
        finally:
            await server.drain()

    from pycatkin_tpu.frontend import abi as jabi
    for key in list(os.environ):
        if key.startswith("PYCATKIN_"):
            monkeypatch.delenv(key)
    # The JAX coalescer keys groups by fingerprint under its ABI gate.
    monkeypatch.setenv(jabi.ABI_ENV, "1")
    return asyncio.run(scenario())


def test_both_servers_build_the_same_response(sims, monkeypatch):
    sim = sims[0]
    terms = [sim.spec.rnames[-1]]
    payload = {"op": "sweep", "id": "q", "mechanism": system_to_dict(sim),
               "conditions": {"T": T_GRID}, "tof_terms": terms,
               "wait_budget_s": 0.0, "return": ["y"]}

    async def ours():
        server = await _server().start(listen=False)
        try:
            return await server.handle(payload)
        finally:
            await server.drain()

    mine = asyncio.run(ours())
    conds = batch.stack_conditions([sim.conditions(T=t, p=1e5)
                                    for t in T_GRID])
    out = batch.sweep_steady_state(sim.spec, conds,
                                   engine.tof_mask_for(sim.spec, terms),
                                   abi=True, device="cpu")
    theirs = _jax_response(monkeypatch, payload,
                           [{k: v.numpy() for k, v in out.items()}])
    assert mine["ok"] and theirs["ok"], theirs.get("error")
    assert set(mine) == set(theirs)
    for key in ("result", "quarantine", "lane_telemetry", "lanes", "id",
                "protocol"):
        assert json.dumps(mine[key]) == json.dumps(theirs[key]), key
    assert set(mine["pack"]) == set(theirs["pack"])
    assert set(mine["timing"]) == set(theirs["timing"])
    assert set(theirs["manifest"]) <= set(mine["manifest"])
    assert mine["manifest"]["abi"] == theirs["manifest"]["abi"]


def test_one_sweep_answered_by_both_servers(sims, monkeypatch):
    from pycatkin_tpu.frontend import abi as jabi
    from pycatkin_tpu.serve.server import SweepServer as JaxServer
    sim = sims[0]
    payload = {"op": "sweep", "id": "q", "mechanism": system_to_dict(sim),
               "conditions": {"T": T_GRID},
               "tof_terms": [sim.spec.rnames[-1]], "wait_budget_s": 0.0}

    async def ask(server):
        await server.start(listen=False)
        try:
            return await server.handle(payload)
        finally:
            await server.drain()

    mine = asyncio.run(ask(_server()))
    monkeypatch.setenv(jabi.ABI_ENV, "1")
    theirs = asyncio.run(ask(JaxServer(jprotocol.ServeConfig())))
    assert mine["ok"] and theirs["ok"], theirs.get("error")
    assert set(mine) == set(theirs)
    assert set(mine["result"]) == set(theirs["result"])
    for key in ("success", "quarantined", "attempts"):
        assert mine["result"][key] == theirs["result"][key], key
    for key in ("residual", "tof", "activity"):
        np.testing.assert_allclose(mine["result"][key],
                                   theirs["result"][key], rtol=1e-5,
                                   atol=1e-12)


def test_lines_longer_than_the_asyncio_default(sims):
    """A 2,400-lane request (~70 KB of JSON) and its answer (~300 KB)
    pass the wire: both ends read lines up to ``protocol.LINE_LIMIT``,
    not asyncio's 64 KiB."""
    T = [float(t) for t in np.linspace(480.0, 520.0, 2400)]

    async def scenario():
        server = await _server().start()
        tcp = await TcpSweepClient("127.0.0.1", server.port).connect()
        try:
            payload = sweep_payload(system_to_dict(sims[1]), T,
                                    p=[1e5] * len(T), wait_budget_s=0.0)
            assert len(json.dumps(payload)) > 1 << 16
            return await tcp.request(payload)
        finally:
            await tcp.close()
            await server.drain()

    resp = asyncio.run(scenario())
    assert resp["ok"], resp.get("error")
    assert len(json.dumps(resp)) > 1 << 16
    assert json.dumps(resp["result"]) == json.dumps(_solo_result(sims[1],
                                                                 T=T))
