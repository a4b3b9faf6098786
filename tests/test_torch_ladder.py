"""The port's sweep failure path against the JAX package's on identical
data: the rescue ladder (neighbor-seeded polish, PTC, LM), the
quarantine re-check, the stability verdict and the demote loop of
``sweep_steady_state``, on the JAX package's failure corpus and on the
bistable mechanism; ``stability_mask`` and ``engine.check_stability``;
``batch_steady_state`` and ``continuation_sweep``.

Verdict masks, strategy codes, attempts and iterations are held
bitwise; states, TOF and activity by the rule of
``tests/test_torch_rescue.py`` (the envelope where the reference
reproduces itself to it, else twice its own one-ulp spread, and the
JAX engine's convergence test on every converged lane)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from pycatkin_tpu import engine as jengine
from pycatkin_tpu.parallel import batch as jbatch
from pycatkin_tpu_torch import engine
from pycatkin_tpu_torch.parallel import batch
from pycatkin_tpu_torch.solvers import newton
from tests.test_torch_rescue import (INTS, MASKS, RESIDUAL_SLACK, ULP,
                                     _case, _envelope_ok, _hold,
                                     _jax_normalized_residual, _jax_route,
                                     _jopts, _port_conds, _port_spec)

CORPUS = newton.SolverOptions(max_steps=6, max_attempts=2)


# ----------------------------------------------------------------------
# (c) the sweep's failure path on the JAX package's failure corpus
@pytest.fixture(scope="module", params=[False, True], ids=["plain", "abi"])
def corpus(request):
    """Synthetic (24, 32), 48 lanes, T 400-800 K, ``max_steps=6,
    max_attempts=2`` (``tests/test_consolidated_rescue.py``): every lane
    fails the fast pass. The port's sweep, the JAX sweep and three JAX
    sweeps with T up, T down and kscale up one ulp."""
    use_abi = request.param
    sj, cj, mask = _case(24, 32, 48, (400.0, 800.0))
    kw = dict(tof_mask=mask, opts=_jopts(CORPUS), check_stability=True)
    with _jax_route(use_abi=use_abi):
        pj = [{k: np.asarray(v) for k, v in jbatch.sweep_steady_state(
            sj, c, **kw).items()} for c in (
                cj, cj._replace(T=cj.T * ULP), cj._replace(T=cj.T / ULP),
                cj._replace(kscale=cj.kscale * ULP))]
    pt = batch.sweep_steady_state(_port_spec(sj), _port_conds(cj), mask,
                                  opts=CORPUS, check_stability=True,
                                  abi=use_abi, device="cpu")
    return sj, cj, pt, pj


def test_corpus_verdicts_and_counts_match_jax(corpus):
    _, _, pt, (pj, *_) = corpus
    assert sorted(pt) == sorted(pj)
    for k in MASKS + INTS:
        got = pt[k].numpy()
        assert got.dtype == pj[k].dtype and np.array_equal(got, pj[k]), k
    tel = pt["lane_telemetry"].numpy()
    assert tel.dtype == np.int32 and tel.shape == pj["lane_telemetry"].shape
    # iterations, chords, strategy and tier bitwise; the residual decade
    # of an independently rounded converged iterate is rounding noise.
    cols = [0, 1, 3, 4]
    assert np.array_equal(tel[:, cols], pj["lane_telemetry"][:, cols])


def test_corpus_ladder_ran(corpus):
    """Every lane failed the fast pass; the polish rung recovered each
    one (strategy code 1) and the sweep ends converged and stable."""
    _, _, pt, (pj, *_) = corpus
    codes = pt["lane_telemetry"][:, 3].numpy()
    assert np.all(codes == newton.STRATEGY_CODES["polish"])
    assert bool(pt["success"].all()) and bool(pt["stable"].all())
    assert np.all(pt["attempts"].numpy() == 2)


@pytest.mark.parametrize("field", ["y", "tof", "activity"])
def test_corpus_states_match_jax(corpus, field):
    _, _, pt, (pj, *spreads) = corpus
    assert pt[field].shape == pj[field].shape
    _hold(field, pt[field], pj[field], [s[field] for s in spreads])


def test_corpus_states_pass_the_jax_convergence_test(corpus):
    sj, cj, pt, _ = corpus
    r = _jax_normalized_residual(sj, cj, pt["y"])
    ok = pt["success"].numpy()
    assert np.all(r[ok] <= 1.0 + RESIDUAL_SLACK), r[ok]
    assert bool((pt["residual"][pt["success"]] <= 1.0).all())


# ----------------------------------------------------------------------
# (d) the demote loop on the bistable mechanism
def _bistable():
    from tests.test_verdicts import A_STABLE, A_UNSTABLE, _full_y
    from tests.test_verdicts import bistable as fixture
    sim = fixture.__wrapped__()
    dyn = np.asarray(sim.spec.dynamic_indices)
    cj = jbatch.stack_conditions([sim.conditions()] * 3)
    ys = np.stack([_full_y(sim, a) for a in (A_UNSTABLE, A_STABLE, 0.0)])
    return sim.spec, cj, ys, ys[:, dyn], A_UNSTABLE, A_STABLE


def test_demote_loop_matches_jax():
    """Lane 0 starts on the unstable root, converges there, is demoted by
    the host eigensolve and re-solved unseeded onto a stable root; lanes
    1 and 2 start on the stable roots and stay."""
    sj, cj, _, x0, a_unstable, a_stable = _bistable()
    with _jax_route():
        pj = {k: np.asarray(v) for k, v in jbatch.sweep_steady_state(
            sj, cj, x0=x0, check_stability=True).items()}
    pt = batch.sweep_steady_state(_port_spec(sj), _port_conds(cj), x0=x0,
                                  check_stability=True, device="cpu")
    for k in MASKS + INTS:
        assert np.array_equal(pt[k].numpy(), pj[k]), k
    tel = pt["lane_telemetry"].numpy()
    assert np.array_equal(tel[:, 3], pj["lane_telemetry"][:, 3])
    assert tel[0, 3] == newton.STRATEGY_CODES["demote"]
    assert bool(pt["success"].all()) and bool(pt["stable"].all())
    a = pt["y"][:, sj.sindex("sa")].numpy()
    assert abs(a[0] - a_unstable) > 1e-3
    assert abs(a[0] - a_stable) < 1e-6 or abs(a[0]) < 1e-6
    assert abs(a[1] - a_stable) < 1e-6 and abs(a[2]) < 1e-6
    assert _envelope_ok(pt["y"], pj["y"])


def test_card_bistable_is_the_jax_fixture():
    """The bistable mechanism that the card tests build with the port's
    frontend alone (``tests/test_torch_cuda.py``, which imports no JAX)
    is the JAX fixture's: every spec field, the three lanes' conditions
    and their starts equal."""
    from tests.test_torch_cuda import bistable_port
    sj, cj, _, x0, _, _ = _bistable()
    sp, conds, x0_port = bistable_port()
    want = _port_spec(sj)
    for f in dataclasses.fields(want):
        a, b = getattr(sp, f.name), getattr(want, f.name)
        assert np.array_equal(np.asarray(a), np.asarray(b)), f.name
    for f, a in zip(conds._fields, conds):
        assert np.array_equal(a, np.asarray(getattr(cj, f))), f
    assert np.array_equal(x0_port, x0)


def test_stability_verdicts_match_jax():
    """``engine.check_stability`` and ``stability_mask`` on the bistable
    mechanism's three roots (unstable, stable, stable)."""
    sj, cj, ys, _, _, _ = _bistable()
    ds = engine.bind(_port_spec(sj), "cpu")
    ct = engine.conditions_to(_port_conds(cj), "cpu")
    got = engine.check_stability(ds, ct, torch.tensor(ys))
    want = [jengine.check_stability(sj, jax.tree_util.tree_map(
        lambda a: a[i], cj), ys[i]) for i in range(3)]
    assert got.tolist() == want == [False, True, True]
    mask = batch.stability_mask(_port_spec(sj), _port_conds(cj), ys,
                                device="cpu")
    assert np.array_equal(mask.numpy(), np.asarray(
        jbatch.stability_mask(sj, cj, ys)))


# ----------------------------------------------------------------------
# (e) the entries that ride on the solve
@pytest.fixture(scope="module")
def small():
    return _case(10, 5, 8, (450.0, 650.0))


def test_batch_steady_state_matches_jax(small):
    """Default options: five attempts, keys ``split(PRNGKey(0), L)``."""
    sj, cj, _ = small
    with _jax_route():
        rj = jbatch.batch_steady_state(sj, cj)
    rt = batch.batch_steady_state(_port_spec(sj), _port_conds(cj),
                                  device="cpu")
    for name in ("success", "attempts", "iterations", "rate_ok", "pos_ok",
                 "sums_ok", "chords"):
        assert np.array_equal(getattr(rt, name).numpy(),
                              np.asarray(getattr(rj, name))), name
    assert bool(rt.success.all())
    assert _envelope_ok(rt.x, rj.x)


def test_continuation_sweep_matches_jax(small):
    """Two stages of four lanes, interleaved in T; with the stability
    check and TOF."""
    sj, cj, mask = small
    order = np.array([[0, 2, 4, 6], [1, 3, 5, 7]])
    with _jax_route():
        pj = {k: np.asarray(v) for k, v in jbatch.continuation_sweep(
            sj, cj, order, tof_mask=mask, check_stability=True).items()}
    pt = batch.continuation_sweep(_port_spec(sj), _port_conds(cj), order,
                                  tof_mask=mask, check_stability=True,
                                  device="cpu")
    assert sorted(pt) == sorted(pj)
    for k in MASKS + INTS:
        assert np.array_equal(pt[k].numpy(), pj[k]), k
    for k in ("y", "tof", "activity"):
        assert _envelope_ok(pt[k], pj[k]), k
    with pytest.raises(ValueError, match="every lane index"):
        batch.continuation_sweep(_port_spec(sj), _port_conds(cj),
                                 order[:, :3], device="cpu")


def test_entries_refuse_a_mesh(small):
    sj, cj, _ = small
    with pytest.raises(NotImplementedError, match="Queue A item 12"):
        batch.batch_steady_state(_port_spec(sj), _port_conds(cj),
                                 mesh=object(), device="cpu")
