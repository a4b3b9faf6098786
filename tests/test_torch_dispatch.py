"""The port's request coalescer (``parallel.dispatch``): the JAX package's
five queue-only edge cases (``tests/test_serve.py``) unchanged -- due
exactly at its deadline, a backwards clock, ``flush_all`` racing a
forced ``result()``, solo keys that never alias, ``take_group``
requeueing the rest; group keys by the JAX package's ABI fingerprints
(the soak's generator, buckets 16, 32 and 128, seeds 0-5); and the
packed front door on the CPU, each tenant bit for bit its solo
``sweep_steady_state(..., abi=True)``. Only the last case solves."""

import types

import numpy as np
import pytest
import torch

from pycatkin_tpu.frontend import abi as jabi
from pycatkin_tpu.models.synthetic import synthetic_system_for_bucket \
    as jbucket
from pycatkin_tpu_torch import engine
from pycatkin_tpu_torch.frontend import abi
from pycatkin_tpu_torch.models.synthetic import synthetic_system_for_bucket
from pycatkin_tpu_torch.parallel import batch, dispatch
from pycatkin_tpu_torch.parallel.dispatch import SweepCoalescer
from pycatkin_tpu_torch.utils import io

N_LANES = 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread is as fast and spares the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stub_coalescer(calls, **kwargs):
    def runner(sims, conds_list, masks, x0s, **kw):
        calls.append(len(sims))
        return [{"success": np.ones(N_LANES, bool)} for _ in sims]

    kwargs.setdefault("max_occupancy", 8)
    kwargs.setdefault("max_wait_s", 1e9)
    return SweepCoalescer(runner=runner, autoflush=False, **kwargs)


def _fake_request():
    sim = types.SimpleNamespace()  # unfittable -> solo group
    conds = types.SimpleNamespace(T=np.linspace(450.0, 550.0, N_LANES))
    return sim, conds


def test_coalescer_request_due_exactly_at_its_deadline():
    calls = []
    co = _stub_coalescer(calls)
    sim, conds = _fake_request()
    req = co.submit(sim, conds, wait_budget_s=5.0)
    deadline = req.submitted_at + 5.0
    # A hair early: not due. At the deadline, to the bit: due.
    assert co.due_keys(now=deadline - 1e-9) == []
    assert co.poll(now=deadline - 1e-9) == 0
    assert co.due_keys(now=deadline) == [req.group_key]
    assert co.poll(now=deadline) == 1
    assert req.done and calls == [1] and co.pending == 0


def test_coalescer_backwards_clock_reports_nothing_due():
    calls = []
    co = _stub_coalescer(calls)
    sim, conds = _fake_request()
    req = co.submit(sim, conds, wait_budget_s=0.0)
    # wait_budget_s=0 means due NOW -- but a clock that moved
    # backwards must not flush (or crash) anything early.
    past = req.submitted_at - 3600.0
    assert co.due_keys(now=past) == []
    assert co.poll(now=past) == 0
    assert not req.done and co.pending == 1
    assert co.poll(now=req.submitted_at) == 1
    assert req.done


def test_coalescer_flush_all_racing_forced_result():
    calls = []
    co = _stub_coalescer(calls)
    sim, conds = _fake_request()
    req = co.submit(sim, conds)
    out = req.result()               # caller-forced flush wins
    assert out["success"].all() and calls == [1]
    assert co.flush_all() == 0       # the loser sees an empty queue
    assert calls == [1]              # and never re-runs the group

    req2 = co.submit(*_fake_request())
    assert co.flush_all() == 1       # scheduler-side flush wins
    assert req2.result()["success"].all()
    assert calls == [1, 1]           # result() returned the cache
    # The benign half of the take race: an already-taken key is [].
    assert co.take_group(req2.group_key) == []


def test_coalescer_solo_keys_never_alias():
    calls = []
    co = _stub_coalescer(calls)
    sim, conds = _fake_request()
    # Same unfittable sim submitted twice: two DISTINCT solo groups
    # (id(sim) is reusable after GC; the monotonic counter is not).
    r1 = co.submit(sim, conds)
    r2 = co.submit(sim, conds)
    assert r1.group_key != r2.group_key
    assert r1.group_key[0] == "solo" and r2.group_key[0] == "solo"
    assert co.pending == 2 and len(co._groups) == 2
    co.flush_all()
    assert calls == [1, 1]           # never co-flushed


def test_coalescer_take_group_limit_requeues_remainder():
    calls = []
    co = _stub_coalescer(calls)
    co._group_key = lambda *a, **k: ("fp", N_LANES, False, False)
    reqs = [co.submit(*_fake_request(), wait_budget_s=b)
            for b in (10.0, 4.0, 7.0)]
    key = reqs[0].group_key
    taken = co.take_group(key, limit=2)
    assert taken == reqs[:2] and co.pending == 1
    # The remainder's deadline is recomputed from ITS members only.
    assert co._deadlines[key] == pytest.approx(
        reqs[2].submitted_at + 7.0)
    co.run_requests(key, taken)
    assert reqs[0].done and reqs[1].done and not reqs[2].done
    co.flush_all()
    assert reqs[2].done and calls == [2, 1]


@pytest.mark.parametrize("bucket", [16, 32, 128])
def test_fingerprints_and_group_keys_are_the_jax_packages(bucket):
    co = _stub_coalescer([])
    for seed in range(6):
        sim = synthetic_system_for_bucket(bucket, seed=seed, device="cpu")
        fp = abi.lower_spec(sim.spec).abi_fingerprint
        assert fp == jabi.lower_spec(jbucket(bucket, seed=seed).spec) \
            .abi_fingerprint
        assert fp == abi.abi_fingerprint_of(abi.select_static(sim.spec))
        conds = types.SimpleNamespace(T=np.zeros(N_LANES))
        assert co._group_key(sim, sim.spec, conds, None, None) == \
            (fp, N_LANES, False, False)
        assert co._group_key(sim, sim.spec, conds, np.ones(3), None) == \
            (fp, N_LANES, True, False)
        # Transients key on the exact grid, apart from sweeps.
        assert co._group_key(sim, sim.spec, conds, None, None,
                             save_ts=[0, 1e-3]) == \
            (fp, N_LANES, "transient", (0.0, 1e-3))
    low = abi.lower_spec(sim.spec)
    assert abi.pack_lowered([low] * 3).abi_fingerprint == fp + ":t4"
    assert abi.pack_lowered([low]).abi_fingerprint == fp
    assert abi.tenant_tag(8) == ":t8" and abi.tenant_tag(1) == ""
    with pytest.raises(ValueError):
        abi.tenant_tag(3)


def test_conditions_round_trip(tmp_path):
    sim = synthetic_system_for_bucket(16, seed=0, device="cpu")
    conds = batch.broadcast_conditions(sim.conditions(), 3)
    path = str(tmp_path / "c.npz")
    dispatch.save_conditions(path, conds)
    back = dispatch.load_conditions(path)
    for a, b in zip(conds, back):
        np.testing.assert_array_equal(a, b)


def test_unported_modes_raise_and_name_the_roadmap(tmp_path):
    """The worker modes run (static is the default, as in the JAX
    package): each equals the in-process sweep of its lane blocks bit for
    bit; a bogus mode still raises, and the AOT cache, which the port
    does not have, is no keyword of either worker mode."""
    sim = synthetic_system_for_bucket(16, seed=0, device="cpu")
    conds = batch.broadcast_conditions(sim.conditions(), 4)._replace(
        T=np.linspace(480.0, 520.0, 4))
    static = dispatch.dispatch_sweep(sim, conds, device="cpu")
    elastic = dispatch.dispatch_sweep(sim, conds, mode="elastic",
                                      chunk=2, device="cpu", timeout=120.0)
    halves = [batch.sweep_steady_state(
        sim.spec, type(conds)(*(v[a:a + 2] for v in conds)), device="cpu")
        for a in (0, 2)]
    for out in (static, elastic):
        assert sorted(out) == sorted(halves[0])
        for key in out:
            np.testing.assert_array_equal(
                out[key], np.concatenate([h[key].numpy() for h in halves]),
                err_msg=key)
    for mode in ("static", "elastic"):
        with pytest.raises(TypeError, match="aot_cache"):
            dispatch.dispatch_sweep(sim, conds, mode=mode, aot_cache="c",
                                    device="cpu")
    with pytest.raises(ValueError):
        dispatch.dispatch_sweep(None, None, mode="bogus")


@pytest.mark.parametrize("option", [
    dict(n_workers=4), dict(worker_env={"X": "1"}), dict(timeout=5.0),
    dict(on_failure="salvage"), dict(aot_cache="cache")])
def test_worker_mode_options_are_refused(option):
    """The worker modes' options are not taken silently: packed mode has
    no workers, so each raises instead of being ignored."""
    with pytest.raises(TypeError):
        dispatch.dispatch_sweep(None, None, mode="packed", device="cpu",
                                **option)


def test_packed_front_door_matches_solo_sweeps_and_logs_flushes(tmp_path):
    sims = [synthetic_system_for_bucket(16, seed=s, device="cpu")
            for s in (0, 1, 2)]
    conds = [batch.broadcast_conditions(s.conditions(), N_LANES)._replace(
        T=np.linspace(480.0, 520.0, N_LANES)) for s in sims]
    terms = [sims[0].spec.rnames[-1]]
    outs = dispatch.dispatch_sweep(sims, conds, tof_terms=terms,
                                   work_dir=str(tmp_path), mode="packed",
                                   device="cpu")
    for sim, c, out in zip(sims, conds, outs):
        mask = engine.tof_mask_for(sim.spec, terms)
        solo = batch.sweep_steady_state(sim.spec, c, mask, abi=True,
                                        device="cpu")
        assert sorted(solo) == sorted(out)
        for key in solo:
            assert torch.equal(solo[key], out[key]), key
    ev = io.read_json_lines(str(tmp_path / dispatch.EVENTS))
    assert len(ev) == 1 and ev[0]["action"] == "pack-flush"
    assert ev[0]["tenants"] == 3 and ev[0]["k_bucket"] == 4
    assert ev[0]["tenant_quarantined"] == [0, 0, 0]
    # A lone transient request runs its solo transient.
    co = SweepCoalescer(device="cpu", autoflush=False)
    ts = [0.0, 1e-9]
    req = co.submit(sims[1], conds[1], save_ts=ts)
    co.flush_all()
    ys, ok = batch.batch_transient(sims[1].spec, conds[1], ts, abi=True,
                                   device="cpu")
    assert torch.equal(req.result()["ys"], ys)
    assert torch.equal(req.result()["ok"], ok)
    assert not bool(req.result()["quarantined"].any())
