"""The port's journaled chunked sweep (``robustness/{journal,chunked,
forensics}``) and the transient's chunked drive, against the JAX
package's.

- The counterparts of ``tests/test_journal_resume.py``'s eight cases and
  of ``tests/test_quarantine.py::test_chunked_quarantine_status_forces_resume``:
  a transient flake absorbed, a kill and a resume bit for bit the
  uninterrupted run, a salvaged chunk re-solved on resume, the
  fingerprint guard, the journal's crash tolerance, the salvage block's
  schema, a quarantined chunk re-solved on resume.
- ``conditions_fingerprint`` is the JAX package's string, for the same
  numpy conditions and the chunked runner's own ``extra`` (the
  ``repr`` of the port's ``SolverOptions`` is the JAX package's).
- The chunked sweep's report and verdicts equal the JAX package's
  chunked sweep on the same chunks, its states within the envelope, and
  the forensics reports of the quarantine drill have the same keys and
  lanes.
- The chunked transient route is the fused route bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from pycatkin_tpu.models.synthetic import synthetic_system as jsynthetic
from pycatkin_tpu.parallel import batch as jbatch
from pycatkin_tpu.robustness import FaultPlan as JFaultPlan
from pycatkin_tpu.robustness import chunked as jchunked
from pycatkin_tpu.robustness import fault_scope as jfault_scope
from pycatkin_tpu.robustness import forensics as jforensics
from pycatkin_tpu.robustness import journal as jjournal
from pycatkin_tpu.solvers.newton import SolverOptions as JSolverOptions
from pycatkin_tpu_torch import engine
from pycatkin_tpu_torch.models.synthetic import synthetic_system
from pycatkin_tpu_torch.parallel import batch
from pycatkin_tpu_torch.robustness import (ChunkAbandonedError,
                                           DegradationPolicy, FaultPlan,
                                           JournalMismatchError,
                                           SweepJournal,
                                           chunked_sweep_steady_state,
                                           conditions_fingerprint,
                                           fault_scope, forensics,
                                           salvage_arrays)
from pycatkin_tpu_torch.robustness.journal import MANIFEST
from pycatkin_tpu_torch.solvers import ode
from pycatkin_tpu_torch.solvers.newton import SolverOptions
from pycatkin_tpu_torch.utils import profiling
from pycatkin_tpu_torch.utils.io import append_json_line, read_json_lines

_FAST = DegradationPolicy(base_delay_s=0.001, max_delay_s=0.002)
_N = 12
_CHUNK = 4
ENV = dict(rtol=1e-5, atol=1e-12)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread is as fast and spares the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    sim = synthetic_system(n_species=10, n_reactions=12, device="cpu")
    spec = sim.spec
    conds = batch.broadcast_conditions(sim.conditions(), _N)
    conds = conds._replace(T=np.linspace(450.0, 650.0, _N))
    mask = engine.tof_mask_for(spec, [spec.rnames[-1]])
    return spec, conds, mask


def _run(problem, **kw):
    spec, conds, mask = problem
    kw.setdefault("chunk", _CHUNK)
    return chunked_sweep_steady_state(spec, conds, tof_mask=mask,
                                      device="cpu", **kw)


@pytest.fixture(scope="module")
def reference_run(problem):
    """The uninterrupted run every resumed run must match bit for bit."""
    out, report = _run(problem)
    assert report["n_failed_lanes"] == 0
    return out, report


def _assert_bit_identical(a, b):
    assert sorted(a.keys()) == sorted(b.keys())
    for k in a:
        assert np.array_equal(a[k], b[k], equal_nan=True), k


def test_transient_fault_absorbed_zero_failed_lanes(problem,
                                                    reference_run):
    profiling.drain_events()
    plan = FaultPlan([{"site": "chunk:1", "kind": "transient"}])
    with fault_scope(plan):
        out, report = _run(problem, policy=_FAST)
    assert [e["kind"] for e in plan.log] == ["transient"]
    assert report["n_failed_lanes"] == 0
    assert report["salvaged"] == []
    _assert_bit_identical(out, reference_run[0])
    evs = profiling.drain_events()
    assert any(e["kind"] == "retry" and e["label"] == "chunk:1"
               for e in evs)


def test_kill_and_resume_bit_identical(problem, reference_run, tmp_path):
    jdir = str(tmp_path / "journal")
    fail_fast = DegradationPolicy(base_delay_s=0.001, max_delay_s=0.002,
                                  requeue=False, host_fallback=False,
                                  salvage=False)
    plan = FaultPlan([{"site": "chunk:1", "kind": "permanent",
                       "times": None}])
    with fault_scope(plan):
        with pytest.raises(ChunkAbandonedError):
            _run(problem, journal=jdir, policy=fail_fast)
    recs = read_json_lines(os.path.join(jdir, MANIFEST))
    done_before = [r["chunk_id"] for r in recs if r.get("kind") == "chunk"
                   and r["status"] == "done"]
    assert done_before == [0]

    out, report = _run(problem, journal=jdir, resume=True)
    assert report["reused"] == [0]
    assert report["n_failed_lanes"] == 0
    _assert_bit_identical(out, reference_run[0])

    out2, report2 = _run(problem, journal=jdir, resume=True)
    assert report2["reused"] == [0, 1, 2]
    _assert_bit_identical(out2, reference_run[0])


def test_card_chunk_recovered_on_the_host_is_not_journaled_done(
        problem, reference_run, tmp_path):
    """A run on the card whose policy opts in to the host fallback: a
    chunk that came back from the CPU is journaled ``host-fallback``,
    not ``done``, so a resume solves it on the card again. With no card
    here, every chunk's dispatch on it fails and the host recovers
    each."""
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    spec, conds, mask = problem
    jdir = str(tmp_path / "journal")
    pol = DegradationPolicy(base_delay_s=0.001, max_delay_s=0.002,
                            requeue=False, host_fallback=True)
    kw = dict(tof_mask=mask, chunk=_CHUNK, device="cuda", journal=jdir,
              policy=pol)
    out, report = chunked_sweep_steady_state(spec, conds, **kw)
    _assert_bit_identical(out, reference_run[0])
    assert report["degraded"] == [0, 1, 2]
    recs = read_json_lines(os.path.join(jdir, MANIFEST))
    assert [r["status"] for r in recs if r.get("kind") == "chunk"] == \
        ["host-fallback"] * 3
    _, again = chunked_sweep_steady_state(spec, conds, resume=True, **kw)
    assert again["reused"] == [] and again["degraded"] == [0, 1, 2]


def test_salvaged_chunk_marks_lanes_and_resolves_on_resume(
        problem, reference_run, tmp_path):
    jdir = str(tmp_path / "journal")
    pol = DegradationPolicy(base_delay_s=0.001, max_delay_s=0.002,
                            requeue=False, host_fallback=False)
    plan = FaultPlan([{"site": "chunk:2", "kind": "permanent",
                       "times": None}])
    with fault_scope(plan):
        out, report = _run(problem, journal=jdir, policy=pol)
    assert report["salvaged"] == [2]
    assert report["n_failed_lanes"] == _CHUNK
    sl = slice(2 * _CHUNK, 3 * _CHUNK)
    assert np.isnan(out["y"][sl]).all()
    assert not out["success"][sl].any()

    out2, report2 = _run(problem, journal=jdir, resume=True)
    assert report2["reused"] == [0, 1]
    assert report2["salvaged"] == []
    _assert_bit_identical(out2, reference_run[0])


def test_resume_rejects_different_conditions(problem, tmp_path):
    spec, conds, mask = problem
    jdir = str(tmp_path / "journal")
    _run(problem, journal=jdir, chunk=_N)
    with pytest.raises(JournalMismatchError):
        chunked_sweep_steady_state(spec, conds._replace(T=conds.T + 1.0),
                                   chunk=_N, tof_mask=mask, journal=jdir,
                                   resume=True, device="cpu")


def test_fresh_journal_refuses_existing_manifest(tmp_path):
    jdir = str(tmp_path / "journal")
    SweepJournal(jdir, fingerprint="abc", n_lanes=4, chunk=2, device="cpu")
    with pytest.raises(RuntimeError, match="resume=True"):
        SweepJournal(jdir, fingerprint="abc", n_lanes=4, chunk=2,
                     device="cpu")


def test_manifest_tolerates_truncated_final_line(tmp_path):
    path = str(tmp_path / "m.jsonl")
    append_json_line(path, {"kind": "header", "version": 1})
    append_json_line(path, {"kind": "chunk", "chunk_id": 0})
    with open(path, "a") as fh:
        fh.write('{"kind": "chu')                 # torn write
    recs = read_json_lines(path)
    assert [r["kind"] for r in recs] == ["header", "chunk"]
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as fh:
        fh.write('{"kind": "hea\n{"kind": "chunk", "chunk_id": 0}\n')
    with pytest.raises(Exception):
        read_json_lines(bad)


def test_conditions_fingerprint_matches_jax(problem):
    """Sensitivity as in the JAX package's test, and the JAX package's
    string for the same conditions and the chunked runner's ``extra``."""
    spec, conds, mask = problem
    base = conditions_fingerprint(conds, extra=("a",))
    assert base == conditions_fingerprint(conds, extra=("a",))
    assert base != conditions_fingerprint(
        conds._replace(T=np.asarray(conds.T) + 1e-9), extra=("a",))
    assert base != conditions_fingerprint(conds, extra=("b",))
    assert repr(SolverOptions()) == repr(JSolverOptions())
    extra = (repr(SolverOptions()), True, 1e-2, _CHUNK, mask.tolist())
    assert conditions_fingerprint(conds, extra) == \
        jjournal.conditions_fingerprint(conds, extra)
    as_tensors = type(conds)(*(torch.as_tensor(v) for v in conds))
    assert conditions_fingerprint(as_tensors, extra) == \
        jjournal.conditions_fingerprint(conds, extra)


def test_salvage_arrays_match_sweep_schema(problem, reference_run):
    spec, _, mask = problem
    ref = reference_run[0]
    salv = salvage_arrays(spec, 3, tof_mask=mask, check_stability=False)
    assert set(salv.keys()) == set(ref.keys())
    for k in ref:
        assert salv[k].dtype == ref[k].dtype, k
        assert salv[k].shape[1:] == ref[k].shape[1:], k
    assert not salv["success"].any()
    assert set(salv) == set(jchunked.salvage_arrays(spec, 3, tof_mask=mask))


def test_chunked_sweep_matches_jax_chunked_sweep(problem, reference_run):
    """The JAX package's chunked sweep on the same chunks: the report and
    the verdicts equal, the states within the envelope; the pipelined
    loop equals the serial one bit for bit."""
    spec, conds, mask = problem
    jsim = jsynthetic(n_species=10, n_reactions=12)
    jout, jrep = jchunked.chunked_sweep_steady_state(
        jsim.spec, conds, chunk=_CHUNK, tof_mask=mask)
    out, rep = reference_run
    assert rep == jrep
    assert sorted(out) == sorted(jout)
    for k in ("success", "quarantined", "rate_ok", "pos_ok", "sums_ok"):
        np.testing.assert_array_equal(out[k], np.asarray(jout[k]), k)
    for k in ("y", "tof"):
        np.testing.assert_allclose(out[k], np.asarray(jout[k]), **ENV,
                                   err_msg=k)
    piped, prep = _run(problem, pipeline=True)
    _assert_bit_identical(piped, out)
    assert prep == rep


def test_chunked_quarantine_status_forces_resume_and_forensics(tmp_path):
    """A chunk whose quarantined lanes stay failed (rescues poisoned too)
    is journaled ``quarantined``, so a resume re-solves it; the JAX
    package's drill gives the same report, and the forensics reports of
    both have the same keys, lanes and histories."""
    sim = synthetic_system(n_species=16, n_reactions=24, seed=3,
                           device="cpu")
    jsim = jsynthetic(n_species=16, n_reactions=24, seed=3)
    conds = jbatch.broadcast_conditions(jsim.conditions(), 16)._replace(
        T=np.linspace(480.0, 620.0, 16))
    mask = engine.tof_mask_for(sim.spec, [sim.spec.rnames[-1]])
    opts = jsim.solver_options()
    specs = [{"site": "batched steady solve", "kind": "nan", "lanes": [5],
              "times": None},
             {"site": "rescue*", "kind": "nan", "times": None}]
    kw = dict(chunk=8, tof_mask=mask, opts=opts, policy=_FAST)
    with fault_scope(FaultPlan(specs)):
        out, report = chunked_sweep_steady_state(
            sim.spec, conds, journal=str(tmp_path / "p"), device="cpu", **kw)
    with jfault_scope(JFaultPlan(specs)):
        jout, jreport = jchunked.chunked_sweep_steady_state(
            jsim.spec, conds, journal=str(tmp_path / "j"), **kw)
    assert report == jreport
    assert report["quarantined"], "no chunk recorded as quarantined"
    quar, succ = out["quarantined"], out["success"]
    assert np.any(quar & ~succ)
    np.testing.assert_array_equal(quar, np.asarray(jout["quarantined"]))
    np.testing.assert_array_equal(succ, np.asarray(jout["success"]))

    rep = forensics.sweep_failure_report(out, conds=conds,
                                         events=report["events"],
                                         device="cpu")
    jrep = jforensics.sweep_failure_report(jout, conds=conds,
                                           events=jreport["events"])
    assert sorted(rep) == sorted(jrep)
    for k in ("n_lanes", "n_failed", "n_quarantined", "quarantined_lanes",
              "truncated", "events", "worker_lifecycle"):
        assert rep[k] == jrep[k], k
    assert [sorted(r) for r in rep["lanes"]] == \
        [sorted(r) for r in jrep["lanes"]]
    for r, j in zip(rep["lanes"], jrep["lanes"]):
        for k in ("lane", "success", "quarantined", "verdict",
                  "conditions", "history", "iterations", "attempts"):
            assert r[k] == j[k], k
    assert forensics.format_failure_report(rep).splitlines()[0] == \
        jforensics.format_failure_report(jrep).splitlines()[0]

    out2, report2 = chunked_sweep_steady_state(
        sim.spec, conds, journal=str(tmp_path / "p"), resume=True,
        device="cpu", **kw)
    assert sorted(report2["reused"]) == sorted(
        set(range(report["n_chunks"])) - set(report["quarantined"]))
    assert bool(np.all(out2["success"]))
    assert not np.any(out2["quarantined"] & ~out2["success"])


@pytest.mark.parametrize("abi", [False, True])
def test_chunked_transient_matches_fused_bitwise(abi):
    """``batch_transient`` on the chunked route (three save times a
    block, forced off a TPU) equals the fused route bit for bit, the
    Newton finish included (``max_steps=5``), with one counted pull a
    block."""
    sim = synthetic_system(12, 14, seed=7, device="cpu")
    conds = batch.broadcast_conditions(sim.conditions(), 4)._replace(
        T=np.linspace(480.0, 560.0, 4))
    save_ts = np.concatenate([[0.0], np.logspace(-9, -2, 9)])
    opts = ode.ODEOptions(max_steps=5)
    fused = batch.batch_transient(sim.spec, conds, save_ts, opts=opts,
                                  abi=abi, device="cpu")
    profiling.reset_sync_count()
    chunked = batch.batch_transient(sim.spec, conds, save_ts, opts=opts,
                                    abi=abi, device="cpu", fused=False,
                                    chunk=3, force_chunking=True)
    labels = profiling.sync_labels()
    assert [x for x in labels if x.startswith("transient chunk")] == \
        [f"transient chunk[{i}]" for i in range(3)]
    assert not bool(fused[1].all())                # the finish ran
    assert torch.equal(fused[0], chunked[0]) and torch.equal(fused[1],
                                                             chunked[1])
    one = batch.batch_transient(sim.spec, conds, save_ts, opts=opts,
                                abi=abi, device="cpu", fused=False)
    assert torch.equal(fused[0], one[0]) and torch.equal(fused[1], one[1])
