"""The port's elastic scheduler (``robustness/scheduler.py``) and worker
exit taxonomy (``utils/retry.classify_worker_exit``).

- The queue, lease, bisection, coverage and exit-taxonomy cases of
  ``tests/test_elastic.py``, with the pure lease and task math held
  against the JAX package's functions on the same inputs.
- A chaos run: subprocess workers on the CPU, two SIGKILLed at their
  first task, a third's heartbeat stalled while it straggles past the
  lease TTL (so the supervisor must kill it), merged bit for bit into the
  undisturbed in-process chunked sweep of the same chunk grid; the
  forensics render its worker lifecycle.
- A poison run: a span that kills every worker touching it is bisected
  down to one lane and quarantined, and every other lane is the
  in-process sweep of its final span, bit for bit.
- ``python -m pycatkin_tpu_torch.robustness.scheduler --drill``.
- ``ServeConfig(runner="elastic")``: a served sweep through the
  scheduler's runner, byte for byte its solo sweep.

The fault plans travel in the workers' configs (``fault_plan``); each
run has a supervisor ``timeout``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from pycatkin_tpu.robustness import scheduler as jscheduler
from pycatkin_tpu.utils import retry as jretry
from pycatkin_tpu_torch.models.synthetic import synthetic_system
from pycatkin_tpu_torch.parallel.batch import (broadcast_conditions,
                                               sweep_steady_state)
from pycatkin_tpu_torch.robustness import chunked_sweep_steady_state
from pycatkin_tpu_torch.robustness.faults import FaultPlan
from pycatkin_tpu_torch.robustness.forensics import (format_failure_report,
                                                     sweep_failure_report,
                                                     worker_lifecycle)
from pycatkin_tpu_torch.robustness.scheduler import (WorkQueue, bisect_span,
                                                     covering_spans,
                                                     lease_expired,
                                                     lease_record,
                                                     parse_task_id,
                                                     run_elastic, task_id)
from pycatkin_tpu_torch.utils.retry import classify_worker_exit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_LANES = 12
CHUNK = 2


# ---------------------------------------------------------------------
# Pure lease/task math, against the JAX package's.

def test_task_id_roundtrip():
    assert task_id(4, 8) == "t00004_00008" == jscheduler.task_id(4, 8)
    assert parse_task_id("t00004_00008") == (4, 8)
    assert parse_task_id(task_id(0, 65536)) == (0, 65536)


def test_lease_expiry_math():
    rec = lease_record("w0-123", ttl_s=30.0, now=1000.0)
    assert rec == jscheduler.lease_record("w0-123", ttl_s=30.0, now=1000.0)
    assert rec["deadline"] == 1030.0
    assert not lease_expired(rec, 1029.9)
    assert lease_expired(rec, 1030.0)
    assert lease_expired({}, 0.0)            # malformed = expired
    stolen = lease_record("w1-456", 30.0, 1040.0, stolen_from="w0-123")
    assert stolen["stolen_from"] == "w0-123"


@pytest.mark.parametrize("span", [(0, 8, 4), (0, 7, 4), (4, 6, 1),
                                  (4, 5, 1), (0, 4096, 1), (3, 9, 2)])
def test_bisect_floor(span):
    assert bisect_span(*span) == jscheduler.bisect_span(*span)
    want = {(0, 8, 4): 4, (0, 7, 4): None, (4, 6, 1): 5, (4, 5, 1): None,
            (0, 4096, 1): 2048, (3, 9, 2): 6}
    assert bisect_span(*span) == want[span]


def test_covering_spans_tiling_and_overlap():
    def rec(a, b):
        return {"start": a, "stop": b, "tid": task_id(a, b)}

    assert covering_spans([rec(0, 4)], 8) is None          # gap at tail
    assert covering_spans([rec(4, 8)], 8) is None          # gap at head
    full = covering_spans([rec(4, 8), rec(0, 4)], 8)
    assert [(a, b) for a, b, _ in full] == [(0, 4), (4, 8)]
    for recs in ([rec(0, 8), rec(0, 4), rec(4, 8)],
                 [rec(0, 4), rec(4, 8), rec(0, 8)]):
        cover = covering_spans(recs, 8)
        assert [(a, b) for a, b, _ in cover] == [(0, 8)]
        assert cover == jscheduler.covering_spans(recs, 8)
    cover = covering_spans([rec(0, 6), rec(4, 8)], 8)
    assert [(a, b) for a, b, _ in cover] == [(0, 6), (4, 8)]


@pytest.mark.parametrize("rc,timed_out", [(0, False), (-9, False),
                                          (-15, False), (3, False),
                                          (None, True), (None, False),
                                          (-200, False)])
def test_classify_worker_exit_taxonomy(rc, timed_out):
    got = classify_worker_exit(rc, timed_out=timed_out)
    want = jretry.classify_worker_exit(rc, timed_out=timed_out)
    assert (got.kind, got.transient, got.detail) == \
        (want.kind, want.transient, want.detail)


def test_claim_is_first_wins(tmp_path):
    q = WorkQueue(str(tmp_path)).setup()
    tid = q.add_task(0, 4)
    assert q.claim(tid, "w0-1", ttl_s=10.0, now=100.0)
    assert not q.claim(tid, "w1-2", ttl_s=10.0, now=100.0)
    assert q.read_lease(tid)["owner"] == "w0-1"


def test_renew_is_fenced(tmp_path):
    q = WorkQueue(str(tmp_path)).setup()
    tid = q.add_task(0, 4)
    q.claim(tid, "w0-1", ttl_s=10.0, now=100.0)
    assert q.renew(tid, "w0-1", ttl_s=10.0, now=105.0)
    assert q.read_lease(tid)["deadline"] == 115.0
    assert not q.renew(tid, "w1-2", ttl_s=10.0, now=105.0)
    q.requeue(tid)
    q.claim(tid, "w1-2", ttl_s=10.0, now=106.0, stolen_from="w0-1")
    assert not q.renew(tid, "w0-1", ttl_s=10.0, now=107.0)
    assert q.read_lease(tid)["owner"] == "w1-2"


def test_claim_next_steals_only_expired(tmp_path):
    q = WorkQueue(str(tmp_path)).setup()
    tid = q.add_task(0, 4)
    q.claim(tid, "w0-1", ttl_s=1.0, now=100.0)
    assert q.claim_next("w1-2", ttl_s=1.0, now=100.5) is None
    assert q.claim_next("w1-2", ttl_s=1.0, now=102.0) == (tid, "w0-1")
    assert q.read_lease(tid)["stolen_from"] == "w0-1"


def test_done_record_is_exclusive(tmp_path):
    q = WorkQueue(str(tmp_path)).setup()
    tid = q.add_task(0, 4)
    assert q.write_done(tid, {"tid": tid, "start": 0, "stop": 4,
                              "status": "done", "owner": "w0-1"})
    assert not q.write_done(tid, {"tid": tid, "start": 0, "stop": 4,
                                  "status": "done", "owner": "w1-2"})
    assert q.done()[tid]["owner"] == "w0-1"
    assert not q.stop_requested()
    q.request_stop()
    assert q.stop_requested()


def test_fault_budget_is_fleet_wide(tmp_path):
    """A restarted worker re-reading the same ``times=1`` plan from its
    config does not re-fire it when the plan has a ``state_dir``."""
    plan_text = json.dumps({
        "specs": [{"site": "s", "kind": "stall", "times": 1,
                   "delay_s": 0.0}],
        "state_dir": str(tmp_path / "faultstate")})
    first = FaultPlan.from_json(plan_text)
    first.on_call("s")
    assert [e["kind"] for e in first.log] == ["stall"]
    second = FaultPlan.from_json(json.loads(plan_text))
    second.on_call("s")
    assert second.log == []
    local = [{"site": "s", "kind": "stall", "times": 1, "delay_s": 0.0}]
    for plan in (FaultPlan.from_json(local), FaultPlan.from_json(local)):
        plan.on_call("s")
        assert len(plan.log) == 1
    assert FaultPlan.from_json("") is None and FaultPlan.from_json(None) \
        is None


# ---------------------------------------------------------------------
# The chaos and poison runs, with subprocess workers on the CPU.

def _drill():
    sim = synthetic_system(n_species=8, n_reactions=10, seed=0,
                           device="cpu")
    conds = broadcast_conditions(sim.conditions(), N_LANES)
    return sim, conds._replace(T=np.linspace(450.0, 650.0, N_LANES))


def _spans_reference(sim, conds, spans):
    """The in-process sweep of each span, concatenated in lane order."""
    parts = [{k: v.numpy() for k, v in sweep_steady_state(
        sim.spec, type(conds)(*(f[a:b] for f in conds)),
        device="cpu").items()} for a, b in spans]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


@pytest.fixture(scope="module")
def chaos_run(tmp_path_factory):
    sim, conds = _drill()
    td = tmp_path_factory.mktemp("chaos")
    # Worker 2 straggles at its first task for longer than the lease TTL
    # while its heartbeat stalls: the supervisor sees a live owner of an
    # expired lease and kills it.
    plan = {"specs": [
        {"site": "worker:0", "kind": "worker-crash", "times": 1},
        {"site": "worker:1", "kind": "worker-crash", "times": 1},
        {"site": "worker:2", "kind": "slow-worker", "times": 1,
         "delay_s": 6.0},
        {"site": "heartbeat:2", "kind": "heartbeat-stall", "times": 1,
         "delay_s": 120.0}],
        "state_dir": str(td / "faultstate")}
    out, report = run_elastic(
        sim, conds, n_workers=3, chunk=CHUNK, work_dir=str(td / "work"),
        fault_plan=plan, device="cpu", ttl_s=3.0, heartbeat_s=0.25,
        max_kills=5, restart_base_s=0.2, restart_max_s=1.0, timeout=240.0)
    return sim, conds, out, report


def test_chaos_bit_identity(chaos_run):
    sim, conds, out, report = chaos_run
    crashes = [e for e in report["exits"]
               if e["kind"] == "signal-death" and not e["self_killed"]]
    stalled = [e for e in report["exits"] if e["self_killed"]]
    assert len(crashes) >= 2
    assert len(stalled) >= 1
    assert report["restarts"] >= 3
    assert report["leases"]["expired"] >= 1
    assert report["quarantined"] == []
    assert report["n_failed_lanes"] == 0
    ref, _ = chunked_sweep_steady_state(sim.spec, conds, chunk=CHUNK,
                                        device="cpu")
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(
            out[k], ref[k],
            err_msg=f"chaos run diverged from undisturbed sweep at {k!r}")


def test_chaos_forensics_lifecycle(chaos_run):
    _, conds, out, report = chaos_run
    wl = worker_lifecycle(report["events"])
    assert wl["n_restarts"] >= 3
    assert wl["spawns"] >= 6
    assert "worker:2" in wl["killed_stalled"]
    assert wl["leases_expired"]
    assert wl["quarantined"] == []
    full = sweep_failure_report(out, conds=conds, events=report["events"],
                                device="cpu")
    assert full["worker_lifecycle"]["n_restarts"] == wl["n_restarts"]
    text = format_failure_report(full)
    assert "worker lifecycle" in text and "restarted" in text
    assert "killed for stalled heartbeat" in text


def test_poison_bisected_to_floor_and_quarantined(tmp_path):
    sim, conds = _drill()
    # Unlimited crash on any task starting at lane 4: the id encodes the
    # span, so the pattern follows the poison through bisection
    # ([4,8) -> [4,6) -> [4,5)) while the healthy halves escape it.
    plan = [{"site": "lease:t00004_*", "kind": "worker-crash",
             "times": None}]
    out, report = run_elastic(
        sim, conds, n_workers=2, chunk=4, min_chunk=1, max_kills=1,
        work_dir=str(tmp_path / "work"), fault_plan=plan, device="cpu",
        ttl_s=6.0, heartbeat_s=0.5, restart_base_s=0.2, restart_max_s=1.0,
        timeout=240.0)
    assert set(report["bisected"]) == {"t00004_00008", "t00004_00006"}
    assert report["quarantined"] == ["t00004_00005"]
    assert report["restarts"] >= 3
    success = np.asarray(out["success"], dtype=bool)
    assert not success[4] and success[np.arange(N_LANES) != 4].all()
    quarantined = np.asarray(out["quarantined"], dtype=bool)
    assert quarantined[4] and int(quarantined.sum()) == 1
    keep = np.arange(N_LANES) != 4
    ref = _spans_reference(sim, conds, [(0, 4), (5, 6), (6, 8), (8, 12)])
    for k in ref:
        np.testing.assert_array_equal(out[k][keep], ref[k], err_msg=k)
    events = [json.loads(line) for line in
              open(tmp_path / "work" / "events.jsonl")]
    assert events[0]["kind"] == "header"
    assert {"task-bisected", "task-quarantined", "restart"} <= \
        {e.get("action") for e in events}


def test_chaos_drill_command_line():
    proc = subprocess.run(
        [sys.executable, "-m", "pycatkin_tpu_torch.robustness.scheduler",
         "--drill", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=240)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout)
    assert result["ok"] and result["restarts"] >= 1
    assert result["n_failed_lanes"] == 0


def test_elastic_serve_runner_answers_as_a_solo_sweep(tmp_path):
    """``ServeConfig(runner="elastic")``: a solo group runs through
    ``packed_group_runner``'s elastic workers, and the answer is the solo
    ``sweep_steady_state(..., abi=True)`` summary, byte for byte."""
    import asyncio

    from pycatkin_tpu_torch.models.synthetic import \
        synthetic_system_for_bucket
    from pycatkin_tpu_torch.parallel.batch import stack_conditions
    from pycatkin_tpu_torch.serve import (ServeConfig, SweepClient,
                                          SweepServer)
    from pycatkin_tpu_torch.serve.protocol import jsonable
    from pycatkin_tpu_torch.serve.server import SUMMARY_KEYS

    sim = synthetic_system_for_bucket(16, seed=0, device="cpu")

    async def scenario():
        server = await SweepServer(ServeConfig(
            runner="elastic", n_workers=1, device="cpu",
            work_dir=str(tmp_path))).start(listen=False)
        try:
            return await SweepClient(server).sweep(sim, [500.0],
                                                   wait_budget_s=0.01)
        finally:
            await server.drain()

    resp = asyncio.run(scenario())
    assert resp["ok"], resp.get("error")
    out = sweep_steady_state(
        sim.spec, stack_conditions([sim.conditions(T=500.0, p=1e5)]),
        abi=True, device="cpu")
    want = jsonable({k: out[k].numpy() for k in SUMMARY_KEYS if k in out})
    assert json.dumps(resp["result"]) == json.dumps(want)
    assert any(d.startswith("packgroup_") for d in os.listdir(tmp_path))
