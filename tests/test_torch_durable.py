"""The port's durable serving (``pycatkin_tpu_torch.serve.durable`` and the
journal-backed router) on the CPU: the cases of the JAX package's
``tests/test_durable.py``, and the journal held against the JAX
package's.

No solver runs here: the journal is plain fsynced JSON lines, and the
router is driven over stub TCP replicas (``torch_serve_stubs.py``).
Smallest first: the journal's accept / answer ledger is idempotent and
crash-replayable (rotation, compaction, a torn final line); the shared
torn-tail reader protects both its callers (the chunk journal and the
request journal); the accepted record is on disk before the ack closure
runs (fsync before ack); a router booted over a journal left by a kill
at each of the three crash points (before the ack, after the ack before
the dispatch, after the answer before compaction) recovers exactly the
right work; duplicate keys are answered bitwise from the journal;
keyless requests are byte-identical with and without a journal; and the
TCP client receives durability acks, fetches journaled results, and
resubmits keyed requests across a severed connection.

Against the JAX package: the same ``record_accepted`` /
``record_answered`` sequence through both packages' ``RequestJournal``
at a tiny ``segment_bytes`` leaves byte-identical segment files, and
each package's journal, replayed by the other, gives the same
``unanswered()`` and ``answered_response()``.

Every scenario runs under its own time limit, and every server in it
closes its connections when it stops (the JAX test of the severed
connection leaves its second connection open after EOF, and on Python
3.12 its ``Server.wait_closed`` then waits forever).
"""

import asyncio
import json
import os

import pytest

from pycatkin_tpu.serve import durable as jdurable
from pycatkin_tpu_torch.robustness.journal import SweepJournal
from pycatkin_tpu_torch.serve.client import TcpSweepClient, sweep_payload
from pycatkin_tpu_torch.serve.durable import RequestJournal
from pycatkin_tpu_torch.serve.protocol import (E_UNKNOWN_KEY,
                                               canonical_answer)
from pycatkin_tpu_torch.serve.router import RouterConfig, SweepRouter
from pycatkin_tpu_torch.utils.io import read_json_lines
from torch_serve_stubs import (FAST_ROUTER, FakeSupervisor, StubReplica,
                               answer_sweep, run, write_line)

SHORT = {"standard": 5.0, "interactive": 2.0}


def durable_config(journal_dir, **overrides):
    kw = dict(FAST_ROUTER, timeouts=SHORT,
              journal_dir=str(journal_dir) if journal_dir else None)
    kw.update(overrides)
    return RouterConfig(**kw)


async def _router_over(replicas, journal_dir, listen=False,
                       **cfg_overrides):
    for r in replicas:
        if r.port is None:
            await r.start()
    return await SweepRouter(
        FakeSupervisor(replicas),
        durable_config(journal_dir, **cfg_overrides)).start(
            listen=listen)


async def _wait_replay(router, timeout_s=10.0):
    deadline = asyncio.get_running_loop().time() + timeout_s
    while router.stats()["durable"]["replay"]["active"]:
        assert asyncio.get_running_loop().time() < deadline, \
            f"replay never finished: {router.stats()['durable']}"
        await asyncio.sleep(0.01)


def _sweep(i=0, key=None):
    return sweep_payload({"mech": "stub"}, [500.0 + i],
                         deadline_class="standard", req_id=f"r{i}",
                         idempotency_key=key)


def _active_segment(jdir):
    segs = sorted(f for f in os.listdir(jdir)
                  if f.startswith("requests_"))
    assert segs, f"no journal segments in {jdir}"
    return os.path.join(jdir, segs[-1])


def _tear_tail(path, torn=b'{"kind": "accepted", "key": "torn'):
    with open(path, "ab") as fh:
        fh.write(torn)


# -- the journal: an idempotent ledger ---------------------------------


def test_journal_idempotent_accept_and_answer(tmp_path):
    j = RequestJournal(str(tmp_path / "j"))
    assert j.segment_bytes == 1 << 20
    assert j.record_accepted("k0", {"op": "sweep"}) is True
    assert j.record_accepted("k0", {"op": "sweep"}) is False
    assert j.is_accepted("k0")
    assert j.unanswered() == [("k0", {"op": "sweep"})]
    resp = {"ok": True, "id": "r0", "result": {"n": 1},
            "quarantine": None, "lanes": None}
    assert j.record_answered("k0", resp) is None
    # A second answer returns the prior stored response (id stripped),
    # so the caller can audit bitwise identity.
    prior = j.record_answered("k0", dict(resp, result={"n": 2}))
    assert prior is not None and prior["result"] == {"n": 1}
    assert "id" not in prior
    assert j.answered_response("k0")["result"] == {"n": 1}
    assert j.unanswered() == []
    # Re-accepting an answered key is a no-op too.
    assert j.record_accepted("k0", {"op": "sweep"}) is False


def test_journal_rotation_compaction_and_pinning(tmp_path):
    jdir = str(tmp_path / "j")
    j = RequestJournal(jdir, segment_bytes=128)
    j.record_accepted("pin", {"op": "sweep", "n": -1})
    for i in range(8):
        j.record_accepted(f"k{i}", {"op": "sweep", "n": i})
        j.record_answered(f"k{i}", {"ok": True, "result": {"n": i},
                                    "quarantine": None, "lanes": 1})
    st = j.stats()
    assert st["rotations"] > 0
    assert st["compacted_segments"] > 0
    assert st["pending"] == 1
    # The unanswered key pins its segment: a fresh replay still knows
    # about it, and the newest answer (in a segment compaction never
    # ran on) is still servable; older answers may have been compacted
    # away (the dedup window's bound).
    j2 = RequestJournal(jdir, segment_bytes=128)
    assert [k for k, _ in j2.unanswered()] == ["pin"]
    assert j2.answered_response("k7")["result"] == {"n": 7}
    assert j2.stats()["replayed_records"] > 0


# -- the journal against the JAX package's -----------------------------


def _journal_script(journal):
    """One accepted / answered sequence, at a segment size that makes
    it rotate and compact, with two keys left unanswered."""
    journal.record_accepted("pin", {"op": "sweep", "n": -1,
                                    "conditions": {"T": [500.0]}})
    for i in range(6):
        journal.record_accepted(f"k{i}", {"op": "sweep", "n": i,
                                          "idempotency_key": f"k{i}"})
        if i != 3:
            journal.record_answered(f"k{i}", {
                "ok": True, "id": f"r{i}", "lanes": 2,
                "result": {"success": [True, i % 2 == 0],
                           "residual": [1e-13 * (i + 1), "nan"],
                           "tof": [0.25 * i, -1.5e-300]},
                "quarantine": {"n_quarantined": i % 2},
                "timing": {"total_s": 0.1 * i}})
    journal.record_answered("k0", {"ok": True, "id": "again",
                                   "result": {"n": "other"}})
    return journal


def _segments(jdir):
    return {f: open(os.path.join(jdir, f), "rb").read()
            for f in sorted(os.listdir(jdir))}


def _replayed(journal):
    keys = ["pin", "torn"] + [f"k{i}" for i in range(6)]
    return (journal.unanswered(),
            {k: journal.answered_response(k) for k in keys},
            {k: journal.is_accepted(k) for k in keys})


def test_journal_files_are_the_jax_packages_byte_for_byte(tmp_path):
    pdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    port = _journal_script(RequestJournal(pdir, segment_bytes=200))
    jax = _journal_script(jdurable.RequestJournal(jdir, segment_bytes=200))
    assert _segments(pdir) == _segments(jdir)
    assert len(_segments(pdir)) >= 2
    assert port.stats()["rotations"] == jax.stats()["rotations"] > 0
    assert port.stats()["compacted_segments"] \
        == jax.stats()["compacted_segments"] > 0
    # Each package replays the other's journal (a torn tail included)
    # to the same state.
    _tear_tail(_active_segment(pdir))
    _tear_tail(_active_segment(jdir))
    cross = [RequestJournal(jdir, segment_bytes=200),
             jdurable.RequestJournal(pdir, segment_bytes=200),
             RequestJournal(pdir, segment_bytes=200),
             jdurable.RequestJournal(jdir, segment_bytes=200)]
    states = [_replayed(j) for j in cross]
    assert all(s == states[0] for s in states[1:])
    assert [k for k, _ in states[0][0]] == ["pin", "k3"]


# -- torn-tail tolerance, per read_json_lines caller -------------------


def test_request_journal_replay_tolerates_torn_tail(tmp_path):
    jdir = str(tmp_path / "j")
    j = RequestJournal(jdir)
    j.record_accepted("good", {"op": "sweep"})
    j.record_answered("good", {"ok": True, "result": {"n": 1},
                               "quarantine": None, "lanes": None})
    seg = _active_segment(jdir)
    _tear_tail(seg)
    # Strict mode sees the damage; the journal's replay drops exactly
    # the torn final record (which was never acked to anyone).
    with pytest.raises(json.JSONDecodeError):
        read_json_lines(seg, tolerate_torn_tail=False)
    j2 = RequestJournal(jdir)
    assert not j2.is_accepted("torn")
    assert j2.answered_response("good")["result"] == {"n": 1}
    # The next append truncates the torn tail first, so the file heals
    # instead of accreting corruption.
    assert j2.record_accepted("after", {"op": "sweep"}) is True
    for rec in read_json_lines(seg, tolerate_torn_tail=False):
        assert rec["key"] != "torn"


def test_chunk_journal_resume_tolerates_torn_tail(tmp_path):
    jdir = str(tmp_path / "chunks")
    j = SweepJournal(jdir, fingerprint="fp", n_lanes=4, chunk=2,
                     device="cpu")
    j.record_chunk(0, 0, 2, "done")
    _tear_tail(j.manifest_path, b'{"kind": "chunk", "chunk_id": 1')
    j2 = SweepJournal(jdir, fingerprint="fp", resume=True, device="cpu")
    assert [r["chunk_id"] for r in j2.chunk_records()] == [0]
    # Resume keeps appending over the healed tail.
    j2.record_chunk(1, 2, 4, "done")
    assert len(read_json_lines(j2.manifest_path,
                               tolerate_torn_tail=False)) >= 3


# -- fsync before ack --------------------------------------------------


def test_accepted_record_is_on_disk_before_ack(tmp_path):
    jdir = str(tmp_path / "j")

    async def scenario():
        stub = StubReplica()
        router = await _router_over([stub], jdir)
        seen_at_ack = []

        async def ack(obj):
            # When the ack closure runs, the accepted record must
            # already be fsynced to the journal.
            on_disk = read_json_lines(_active_segment(jdir),
                                      tolerate_torn_tail=True)
            seen_at_ack.append((dict(obj), [
                (r["kind"], r["key"]) for r in on_disk]))

        try:
            resp = await router.handle(_sweep(0, key="dk0"), ack=ack)
            assert resp["ok"], resp
        finally:
            await router.stop()
            await stub.stop()
        assert len(seen_at_ack) == 1
        obj, on_disk = seen_at_ack[0]
        assert obj["accepted"] is True and obj["key"] == "dk0"
        assert ("accepted", "dk0") in on_disk
        assert ("answered", "dk0") not in on_disk
        # And the answer was journaled before the client saw it.
        final = read_json_lines(_active_segment(jdir),
                                tolerate_torn_tail=True)
        assert ("answered", "dk0") in [(r["kind"], r["key"])
                                       for r in final]
    run(scenario())


# -- the three crash points --------------------------------------------


def test_crash_pre_ack_leaves_no_accepted_work(tmp_path):
    # A kill mid-append, before the ack: the journal holds one torn
    # record. Replay treats the key as never accepted (the client was
    # promised nothing) and a resubmission runs fresh.
    jdir = tmp_path / "j"
    jdir.mkdir()
    (jdir / "requests_00000.jsonl").write_bytes(
        b'{"kind": "accepted", "key": "c0", "pay')

    async def scenario():
        stub = StubReplica()
        router = await _router_over([stub], str(jdir))
        try:
            st = router.stats()["durable"]
            assert st["replay"]["total"] == 0
            assert st["journal"]["pending"] == 0
            resp = await router.handle(_sweep(0, key="c0"))
            assert resp["ok"]
            assert stub.sweeps_seen == 1
        finally:
            await router.stop()
            await stub.stop()
    run(scenario())


def test_crash_post_ack_replays_and_answers(tmp_path):
    # A kill after the ack but before the dispatch: the accepted record
    # is durable, no answer exists. The rebooted router re-dispatches
    # it unprompted and journals the answer.
    jdir = str(tmp_path / "j")
    payload = {k: v for k, v in _sweep(0, key="c1").items()
               if k != "id"}
    RequestJournal(jdir).record_accepted("c1", payload)

    async def scenario():
        stub = StubReplica()
        router = await _router_over([stub], jdir)
        try:
            assert router.stats()["durable"]["replay"]["total"] == 1
            await _wait_replay(router)
            replay = router.stats()["durable"]["replay"]
            assert replay["done"] == 1 and replay["failed"] == 0
            assert replay["wall_s"] is not None
            assert stub.sweeps_seen == 1
            # The answer is fetchable by key, and a duplicate submit is
            # served from the journal without touching the fleet.
            fetched = await router.handle({"op": "result", "key": "c1",
                                           "id": "f0"})
            assert fetched["ok"] and fetched["id"] == "f0"
            dup = await router.handle(_sweep(9, key="c1"))
            assert canonical_answer(dup) == canonical_answer(fetched)
            assert stub.sweeps_seen == 1
            assert router.stats()["durable"]["duplicates_served"] == 1
        finally:
            await router.stop()
            await stub.stop()
    run(scenario())


def test_crash_post_answer_serves_bitwise(tmp_path):
    # A kill after the answer was journaled: the rebooted router has
    # nothing to replay and serves the journaled answer bitwise to a
    # duplicate key.
    jdir = str(tmp_path / "j")
    j = RequestJournal(jdir)
    j.record_accepted("c2", {k: v for k, v in
                             _sweep(0, key="c2").items() if k != "id"})
    answer = {"ok": True, "id": "orig", "result": {"echo": {"T": [7.0]}},
              "quarantine": {"n_quarantined": 0}, "lanes": None}
    j.record_answered("c2", answer)

    async def scenario():
        stub = StubReplica()
        router = await _router_over([stub], jdir)
        try:
            assert router.stats()["durable"]["replay"]["total"] == 0
            dup = await router.handle(_sweep(5, key="c2"))
            assert dup["ok"] and dup["id"] == "r5"
            assert canonical_answer(dup) == canonical_answer(answer)
            assert stub.sweeps_seen == 0
        finally:
            await router.stop()
            await stub.stop()
    run(scenario())


def test_router_replays_a_journal_the_jax_router_left(tmp_path):
    # The JAX package's journal after a kill between ack and dispatch,
    # replayed by the port's router.
    jdir = str(tmp_path / "j")
    payload = {k: v for k, v in _sweep(3, key="x1").items() if k != "id"}
    jdurable.RequestJournal(jdir, segment_bytes=1 << 20).record_accepted(
        "x1", payload)

    async def scenario():
        stub = StubReplica()
        router = await _router_over([stub], jdir)
        try:
            await _wait_replay(router)
            fetched = await router.handle({"op": "result", "key": "x1",
                                           "id": "f"})
            direct = await answer_sweep(dict(payload, id="f"), None)
            assert canonical_answer(fetched) == canonical_answer(direct)
        finally:
            await router.stop()
            await stub.stop()
    run(scenario())


# -- live duplicate handling -------------------------------------------


def test_duplicate_key_bitwise_and_coalescing(tmp_path):
    async def slowish(payload, writer):
        await asyncio.sleep(0.1)
        return await answer_sweep(payload, writer)

    async def scenario():
        stub = StubReplica(behavior=slowish)
        router = await _router_over([stub], str(tmp_path / "j"))
        try:
            # Two concurrent submissions of one key coalesce onto one
            # dispatch; a later resubmission is served from the journal.
            # All three answers are bitwise identical.
            a, b = await asyncio.gather(
                router.handle(_sweep(0, key="dup")),
                router.handle(_sweep(1, key="dup")))
            late = await router.handle(_sweep(2, key="dup"))
            assert a["ok"] and b["ok"] and late["ok"]
            assert len({canonical_answer(r)
                        for r in (a, b, late)}) == 1
            assert (a["id"], b["id"], late["id"]) == ("r0", "r1", "r2")
            assert stub.sweeps_seen == 1
            st = router.stats()["durable"]
            assert st["coalesced"] >= 1
            assert st["duplicates_served"] >= 1
            assert router.stats()["duplicates"]["mismatched"] == 0
        finally:
            await router.stop()
            await stub.stop()
    run(scenario())


def test_keyless_requests_are_byte_identical(tmp_path):
    # A keyless sweep through a journal-backed router is byte-identical
    # to one through a journal-less router: no ack line, nothing
    # journaled.
    async def scenario():
        stub_a, stub_b = StubReplica(), StubReplica()
        plain = await _router_over([stub_a], None)
        durable = await _router_over([stub_b], str(tmp_path / "j"))
        acks = []

        async def ack(obj):
            acks.append(obj)

        try:
            ra = await plain.handle(_sweep(3), ack=ack)
            rb = await durable.handle(_sweep(3), ack=ack)
            assert json.dumps(ra, sort_keys=True) == \
                json.dumps(rb, sort_keys=True)
            assert acks == []
            st = durable.stats()["durable"]["journal"]
            assert st["pending"] == 0 and st["answered"] == 0
        finally:
            await plain.stop()
            await durable.stop()
            await stub_a.stop()
            await stub_b.stop()
    run(scenario())


# -- the TCP client: acks, result fetch, keyed resubmission ------------


def test_tcp_client_acks_and_result_fetch(tmp_path):
    async def scenario():
        stub = StubReplica()
        router = await _router_over([stub], str(tmp_path / "j"),
                                    listen=True)
        cli = await TcpSweepClient("127.0.0.1", router.port).connect()
        try:
            resp = await cli.request(_sweep(0, key="tk0"), timeout=5.0)
            assert resp["ok"] and resp["id"] == "r0"
            assert cli.acks == 1
            fetched = await cli.fetch_result("tk0")
            assert fetched["ok"]
            assert canonical_answer(fetched) == canonical_answer(resp)
            missing = await cli.fetch_result("nope")
            assert missing["ok"] is False
            assert missing["error"]["code"] == E_UNKNOWN_KEY
        finally:
            await cli.close()
            await router.stop()
            await stub.stop()
    run(scenario())


class FlakyServer:
    """Severs its first connection mid-request, then answers normally;
    closes every connection it holds when it stops."""

    def __init__(self):
        self.conns = 0
        self.port = None
        self._server = None
        self._writers = set()

    async def start(self):
        self._server = await asyncio.start_server(
            self._on, "127.0.0.1", 0)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def stop(self):
        self._server.close()
        for w in list(self._writers):
            w.close()
        await self._server.wait_closed()

    async def _on(self, reader, writer):
        self.conns += 1
        sever = self.conns == 1
        self._writers.add(writer)
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                req = json.loads(line)
                if sever:
                    writer.transport.abort()
                    return
                await write_line(writer, {
                    "ok": True, "id": req.get("id"),
                    "result": {"n": 1}, "quarantine": None,
                    "lanes": None})
        except (ConnectionError, asyncio.CancelledError):
            pass
        finally:
            self._writers.discard(writer)
            writer.close()


def test_tcp_client_resubmits_keyed_across_severed_conn():
    # A keyed request survives the cut: the client reconnects,
    # resubmits verbatim, and resolves ok.
    async def scenario():
        srv = await FlakyServer().start()
        cli = await TcpSweepClient(
            "127.0.0.1", srv.port,
            reconnect_base_delay_s=0.01).connect()
        try:
            resp = await cli.request(_sweep(0, key="rk0"), timeout=10.0)
            assert resp["ok"], resp
            assert resp["id"] == "r0"
            assert cli.reconnects >= 1
            assert srv.conns >= 2
        finally:
            await cli.close()
            await srv.stop()
        from pycatkin_tpu_torch.obs import metrics
        assert "pycatkin_serve_reconnects_total" in \
            metrics.snapshot()["counters"]
    run(scenario(), limit_s=20.0)
