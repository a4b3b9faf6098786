"""The port's rescue solves against the JAX package's on identical data:
the direction-solve route, the multi-attempt solve with threefry
restarts (PTC and LM), each rescue rung's solve against the JAX
package's consolidated rescue program, and a lane's independence of its
batch (the sweep's failure path: ``tests/test_torch_ladder.py``).

Verdict masks, strategy codes, attempts and iterations are held
bitwise. States, TOF and activity are held to the repo's cross-kernel
envelope (rtol 1e-5 / atol 1e-12) wherever the reference reproduces
itself to it, and elsewhere to twice the spread the JAX package shows
against itself when T or kscale move by one ulp (the rule of
``tests/test_torch_sweep.py``): a lane the ladder polishes from a far
start lands anywhere inside the solver's tolerance, and there the JAX
package moves its own converged states by up to ~30 times the envelope
under a one-ulp change, on the LU route as on the Gauss-Jordan one.
Every converged state of the port must also pass the solver's
convergence test as the JAX engine evaluates it."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycatkin_tpu import engine as jengine
from pycatkin_tpu import precision
from pycatkin_tpu.frontend import abi as jabi
from pycatkin_tpu.models.synthetic import synthetic_system
from pycatkin_tpu.ops import linalg as jlinalg
from pycatkin_tpu.parallel import batch as jbatch
from pycatkin_tpu.solvers import newton as jnewton
from pycatkin_tpu_torch import engine
from pycatkin_tpu_torch.frontend.spec import (conditions_from_arrays,
                                              spec_from_arrays)
from pycatkin_tpu_torch.ops import cuda_linalg, linalg, prng
from pycatkin_tpu_torch.parallel import batch
from pycatkin_tpu_torch.solvers import newton

ULP = 1.0 + 2.0 ** -52
# Two evaluations of the residual agree to rtol 1e-12 of |F| + gross
# (tests/test_torch_network.py), which moves the normalized residual by
# up to 1e-12 / rate_tol_rel.
RESIDUAL_SLACK = 1e-12 / jnewton.SolverOptions().rate_tol_rel
MASKS = ("success", "quarantined", "stable", "rate_ok", "pos_ok",
         "sums_ok")
INTS = ("iterations", "attempts", "chords")


def _port_spec(sj):
    return spec_from_arrays(
        {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)})


def _port_conds(cj):
    return conditions_from_arrays(
        {f: np.asarray(getattr(cj, f)) for f in cj._fields})


def _case(ns, nr, L, T):
    sysj = synthetic_system(ns, nr, seed=0)
    sj = sysj.spec
    cj = jbatch.broadcast_conditions(sysj.conditions(), L)._replace(
        T=jnp.linspace(*T, L))
    return sj, cj, jengine.tof_mask_for(sj, [sj.rnames[-1]])


def _jopts(o):
    return jnewton.SolverOptions(*o)


@contextlib.contextmanager
def _jax_route(lu=False, use_abi=False):
    """Both packages on their LU route (``UNROLL_MAX = 0`` in each, the
    JAX LU with its loops not unrolled) or on the stock route; the JAX
    package under ``PYCATKIN_ABI`` and its Pallas kernels in interpret
    mode, as on a TPU; fresh program caches."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(precision.KERNEL_ENV, "pallas")
        mp.setenv(jabi.ABI_ENV, "1" if use_abi else "0")
        if lu:
            mp.setattr(jlinalg, "UNROLL_MAX", 0)
            mp.setattr(linalg, "UNROLL_MAX", 0)
            mp.setattr(jlinalg, "_lu_solve_once",
                       lambda A, b: jlinalg.lu_solve(
                           *jlinalg.lu_factor(A, unroll=1), b, unroll=1))
        jbatch.clear_program_caches()
        jabi.clear_lowering_cache()
        try:
            yield
        finally:
            jbatch.clear_program_caches()
            jabi.clear_lowering_cache()


def _envelope_ok(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.all(np.abs(a - b) <= 1e-12 + 1e-5 * np.abs(b))


def _hold(name, got, ref, spreads):
    """``got`` within the envelope of ``ref``, or within twice the
    largest distance of the reference's one-ulp runs ``spreads``."""
    got, ref = np.asarray(got), np.asarray(ref)
    if _envelope_ok(got, ref):
        return
    own = max(float(np.max(np.abs(np.asarray(s) - ref))) for s in spreads)
    gap = float(np.max(np.abs(got - ref)))
    assert gap <= 2.0 * own, (name, gap, own)


def _jax_normalized_residual(sj, cj, y):
    """The JAX engine's convergence measure per lane at full states
    ``y``: max over the dynamic species of ``|F_i| / (rate_tol +
    rate_tol_rel gross_i)``."""
    opts = jnewton.SolverOptions()

    def one(c, xx):
        kf, kr, _ = jengine.rate_constants(sj, c)
        F, gross = jengine._dynamic_fscale(sj, c, kf, kr)[0](xx)
        return jnp.max(jnp.abs(F) / (opts.rate_tol
                                     + opts.rate_tol_rel * gross))
    dyn = np.asarray(sj.dynamic_indices)
    return np.asarray(jax.jit(jax.vmap(one))(cj, jnp.asarray(
        np.asarray(y)[:, dyn])))


# ----------------------------------------------------------------------
# (a) the direction-solve route
@pytest.mark.parametrize("n", [9, 21, 32, 64])
def test_direction_solve_takes_the_reference_route(n):
    """n <= 48 off the buckets: one Gauss-Jordan solve per right-hand
    side, bit for bit the JAX package's ``_direction_solve``; n = 32 (a
    bucket) and 64: ``lu_solve(*lu_factor(A), b)`` (the kernels' plain
    versions on the CPU)."""
    rng = np.random.default_rng(n)
    A = rng.standard_normal((8, n, n)) + 2.0 * n * np.eye(n)
    A *= 10.0 ** rng.uniform(-8, 8, (8, n, 1))
    b = rng.standard_normal((8, n))
    At, bt = torch.tensor(A), torch.tensor(b)
    got = newton._direction_solve(At, bt)
    cuda_linalg.reset_launches()
    if n <= linalg.UNROLL_MAX and n not in linalg.KERNEL_BUCKETS:
        want = jax.jit(jax.vmap(jnewton._direction_solve))(
            jnp.asarray(A), jnp.asarray(b))
        assert np.array_equal(got.numpy(), np.asarray(want))
        # A chord re-solve through the same closure is the same solve.
        solve = newton._direction_factor(At)
        assert torch.equal(solve(bt), got) and torch.equal(solve(bt), got)
    else:
        want = cuda_linalg.lu_solve(*cuda_linalg.lu_factor(At), bt)
        assert torch.equal(got, want)
    assert set(cuda_linalg.LAUNCHES.values()) == {0}


# ----------------------------------------------------------------------
# (b) the multi-attempt solve, PTC and LM, with threefry restarts
@pytest.fixture(scope="module")
def flagship16():
    sj, cj, mask = _case(24, 32, 16, (400.0, 800.0))
    sp = _port_spec(sj)
    ct = engine.conditions_to(_port_conds(cj), "cpu")
    return sj, cj, mask, sp, ct


@pytest.mark.parametrize("strategy,steps", [("ptc", 6), ("lm", 6),
                                            ("ptc", 20)],
                         ids=["ptc-6", "lm-6", "ptc-20"])
def test_multi_attempt_solve_matches_jax(flagship16, strategy, steps):
    """Three attempts per lane from ``split(PRNGKey(0), L)``: at 6 steps
    every attempt of every lane fails (attempt 2 draws a random start);
    at 20 PTC steps some lanes succeed at their first attempt and the
    rest run all three. LU route in both packages."""
    sj, cj, _, sp, ct = flagship16
    opts = newton.SolverOptions(max_steps=steps, max_attempts=3)
    L = len(ct.T)
    with _jax_route(lu=True):
        rj = jax.jit(jax.vmap(lambda c, k: jengine.steady_state(
            sj, c, key=k, opts=_jopts(opts), strategy=strategy)))(
                cj, jax.random.split(jax.random.PRNGKey(0), L))
        newton.reset_syncs()
        rt = engine.steady_state(engine.bind(sp, "cpu"), ct,
                                 key=prng.split(prng.prng_key(0), L),
                                 opts=opts, strategy=strategy)
    assert 0 < newton.SYNCS["attempt_active"] <= 4
    for name in ("success", "attempts", "iterations", "rate_ok", "pos_ok",
                 "sums_ok", "chords"):
        got, want = getattr(rt, name).numpy(), np.asarray(getattr(rj, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert set(rt.attempts.tolist()) == ({1, 3} if steps == 20 else {3})
    assert _envelope_ok(rt.x, rj.x)
    if strategy == "ptc":
        assert _envelope_ok(rt.dt_exit, rj.dt_exit)


# ----------------------------------------------------------------------
# each rung's solve against the JAX consolidated rescue program
@pytest.fixture(scope="module")
def rescue_rungs(flagship16):
    """Each ladder rung's program on the failed lanes of a 25-step fast
    pass (seeded from their iterates, or unseeded), in both packages on
    the LU route, plus the JAX runs with T up, T down and kscale up one
    ulp."""
    sj, cj, _, sp, ct = flagship16
    opts = newton.SolverOptions(max_steps=25, max_attempts=2)
    ds = engine.bind(sp, "cpu")
    rungs = {"polish": (batch._polish_opts(opts), "ptc", True),
             "ptc": (opts, "ptc", True), "lm": (opts, "lm", True),
             "unseeded": (opts, "ptc", False)}
    out = {}
    with _jax_route(lu=True):
        fast = engine.steady_state(ds, ct, opts=batch.fast_pass_opts(opts))
        failed = np.flatnonzero(~fast.success.numpy())
        assert 0 < failed.size < len(ct.T)
        sub_t = engine.lane_subset(ct, failed)
        keys = prng.split(prng.prng_key(1), failed.size)
        x0 = fast.x[failed][:, ds.dyn]
        runs = []
        jfast_prog = jax.jit(jax.vmap(lambda cc: jengine.steady_state(
            sj, cc, opts=_jopts(batch.fast_pass_opts(opts)))))
        for c in (cj, cj._replace(T=cj.T * ULP), cj._replace(T=cj.T / ULP),
                  cj._replace(kscale=cj.kscale * ULP)):
            jfast = jfast_prog(c)
            sub_j = jax.tree_util.tree_map(lambda a: jnp.asarray(a)[failed],
                                           c)
            prog = jbatch._rescue_program(sj, jbatch._pacing_key(
                _jopts(opts)))
            runs.append({name: prog(
                sub_j, jax.random.split(jax.random.PRNGKey(1), failed.size),
                jnp.asarray(jfast.x)[failed][:, np.asarray(
                    sj.dynamic_indices)],
                np.int32(strat == "lm"), np.bool_(seeded),
                np.float64(o.dt0), np.float64(o.dt_grow_min),
                np.int64(o.max_steps), np.int64(o.max_attempts))
                for name, (o, strat, seeded) in rungs.items()})
        for name, (o, strat, seeded) in rungs.items():
            out[name] = engine.steady_state(
                ds, sub_t, x0=x0 if seeded else None, key=keys, opts=o,
                strategy=strat)
    return sj, cj, failed, out, runs


@pytest.mark.parametrize("rung", ["polish", "ptc", "lm", "unseeded"])
def test_rescue_program_matches_jax(rescue_rungs, rung):
    sj, cj, failed, out, runs = rescue_rungs
    rt, rj = out[rung], runs[0][rung]
    for name in ("success", "attempts", "iterations", "rate_ok", "pos_ok",
                 "sums_ok", "chords"):
        got, want = getattr(rt, name).numpy(), np.asarray(getattr(rj, name))
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    # The states: a recovered lane's converged state, a lane the rung
    # leaves failed its best unconverged iterate (LM's march, on squared
    # condition numbers, moves the JAX package's own by several times the
    # envelope under a one-ulp change).
    ok = rt.success.numpy()
    for lanes in (ok, ~ok):
        _hold("x", rt.x.numpy()[lanes], np.asarray(rj.x)[lanes],
              [np.asarray(r[rung].x)[lanes] for r in runs[1:]])
    env = lambda a: float(np.max(np.abs(np.asarray(a) - np.asarray(rj.x))
                                 / (1e-12 + 1e-5 * np.abs(np.asarray(rj.x)))))
    print(f"{rung}: port vs JAX {env(rt.x):.3g} of the envelope, JAX vs "
          f"its one-ulp runs {max(env(r[rung].x) for r in runs[1:]):.3g}")
    if ok.any():
        sub = jax.tree_util.tree_map(lambda a: jnp.asarray(a)[failed], cj)
        r = _jax_normalized_residual(sj, sub, rt.x)
        assert np.all(r[ok] <= 1.0 + RESIDUAL_SLACK), r[ok]


def test_rescue_rungs_reach_every_branch(rescue_rungs):
    """The corpus is not trivial: polish recovers lanes, and the LM rung
    runs every attempt on the lanes it cannot."""
    _, _, failed, out, _ = rescue_rungs
    assert bool(out["polish"].success.any())
    assert set(out["lm"].attempts.tolist()) == {2}
    assert bool((out["unseeded"].attempts == 2).any())


# ----------------------------------------------------------------------
# (f) a lane's result does not depend on its batch
@pytest.mark.parametrize("strategy", ["ptc", "lm"])
def test_a_lane_alone_matches_its_batch(flagship16, strategy):
    """Each attempt runs only the lanes still failing, so a lane's
    attempts, restarts and verdict are its own: lanes solved alone with
    their own keys give the batch's counts and verdicts, and the same
    states but for BLAS rounding (a matmul's sums are ordered by batch
    size on the CPU)."""
    _, _, _, sp, ct = flagship16
    ds = engine.bind(sp, "cpu")
    opts = newton.SolverOptions(max_steps=20, max_attempts=3)
    keys = prng.split(prng.prng_key(0), len(ct.T))
    rb = engine.steady_state(ds, ct, key=keys, opts=opts, strategy=strategy)
    for i in (2, 9):
        r1 = engine.steady_state(ds, engine.lane_subset(ct, [i]),
                                 key=keys[i:i + 1], opts=opts,
                                 strategy=strategy)
        for name in ("success", "attempts", "iterations"):
            assert getattr(r1, name)[0] == getattr(rb, name)[i], (i, name)
        np.testing.assert_allclose(r1.x[0].numpy(), rb.x[i].numpy(),
                                   rtol=1e-9, atol=1e-13)


def test_multi_attempt_solve_needs_lanes(flagship16):
    """The general loop runs each attempt after the first on the lanes
    still failing, through ``lanes(idx)``; without it the solve refuses
    rather than fail once some lanes have succeeded."""
    _, _, _, sp, ct = flagship16
    ds = engine.bind(sp, "cpu")
    kf, kr, _ = engine.rate_constants(ds, ct)
    cl = engine.closures(ds, ct, kf, kr)
    x0 = cl.y_base[..., ds.dyn].contiguous()
    opts = newton.SolverOptions(max_steps=20, max_attempts=3)
    with pytest.raises(ValueError, match="lanes"):
        newton.solve_steady(cl.fscale, cl.jac, x0, ds.groups_dyn, opts)
    one = newton.solve_steady(cl.fscale, cl.jac, x0, ds.groups_dyn,
                              opts._replace(max_attempts=1))
    assert bool(one[1].any())
