"""The port's stiff integrator (``solvers/ode.py``) and the engine's
full-state closures against the JAX package's, on synthetic (12, 14)
seed 7 (the JAX package's transient problem) with the JAX package's
own rate constants fed to the port's closures.

- The options, the tableaux and the output grid are the JAX package's.
- Given the same rate constants the full-state right-hand side, its
  gross flux and its ``jacfwd`` Jacobian are bit for bit the JAX
  package's.
- One TR-BDF2 step, one ESDIRK4 step and one ``_advance_to`` interval
  are not: the stage matrices of n_s = 24 take the explicit Gauss-Jordan
  inverse in both packages, bit for bit, but each solve is then a
  batched matvec ``Minv @ r``, which XLA's CPU backend sums in another
  order than ``torch.matmul`` (no torch formulation tried reproduced it;
  ``tests/test_torch_linalg.py`` bounds that difference). One step then
  differs by at most a few units in the last place of each lane's
  largest entry, and its error ratio, a filtered difference of nearly
  equal quantities, by up to ~1e-10 relative (ESDIRK4). Over an interval
  the step controller's ``err_ratio ** (-1/q)`` compounds it into the
  step sizes (the last within 6e-8 relative), and two slightly different
  step sequences leave the states apart by a sliver of their local
  error: within 5e-10 of the repo's rtol 1e-5 / atol 1e-12 envelope."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycatkin_tpu import engine as jengine
from pycatkin_tpu.models.synthetic import synthetic_system
from pycatkin_tpu.parallel import batch as jbatch
from pycatkin_tpu.solvers import ode as jode
from pycatkin_tpu_torch import engine
from pycatkin_tpu_torch.frontend.spec import (conditions_from_arrays,
                                              spec_from_arrays)
from pycatkin_tpu_torch.solvers import ode

L = 4
EPS = float(np.finfo(np.float64).eps)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread is as fast and spares the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def case():
    """(JAX spec, JAX conditions, the JAX package's rate constants, the
    port's bound spec and conditions)."""
    sysj = synthetic_system(12, 14, seed=7)
    sj = sysj.spec
    cj = jbatch.broadcast_conditions(sysj.conditions(), L)._replace(
        T=jnp.linspace(480.0, 545.0, L))
    kf, kr, _ = jax.jit(jax.vmap(lambda c: jengine.rate_constants(sj, c)))(
        cj)
    sp = spec_from_arrays(
        {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)})
    ct = engine.conditions_to(conditions_from_arrays(
        {f: np.asarray(getattr(cj, f)) for f in cj._fields}), "cpu")
    return sj, cj, kf, kr, engine.bind(sp, "cpu"), ct


def _jax_fns(sj, c, kf, kr, steady_rel=jode.ODEOptions().steady_rel):
    """The JAX package's transient closures of one lane over given rate
    constants (``engine._transient_closures`` computes its own)."""
    rhs, ras = jengine.make_rhs_and_scale(sj, c, kf, kr)
    floor = 8.0 * float(jnp.finfo(jnp.float64).eps)
    steady = lambda y: jnp.all(jnp.abs(ras(y)[0]) <= floor * ras(y)[1])
    relax = lambda y: jnp.all(jnp.abs(ras(y)[0]) <= steady_rel * ras(y)[1])
    return rhs, jax.jacfwd(rhs), steady, relax


_PROGRAMS = {}


def _jax_program(case, kind, method):
    """One compiled JAX program per kind and method, the step size
    (``"step"``) or the interval's end (``"advance"``) a traced
    argument: ``(conds, kf, kr, y, h_or_t1) -> outputs``, lane-batched."""
    key = (kind, method)
    if key not in _PROGRAMS:
        sj = case[0]
        opts = jode.ODEOptions(method=method)
        jstep = jode._STEP_FNS[method][0]

        def one(c, k1, k2, y, x):
            f, jac, steady, relax = _jax_fns(sj, c, k1, k2)
            if kind == "step":
                return jstep(f, jac, y, 0.0, x, opts)
            return jode._advance_to(f, jac, y, 0.0, x, opts.h0, opts,
                                    steady_fn=steady, relax_fn=relax)
        _PROGRAMS[key] = jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, None)))
    return _PROGRAMS[key]


def _port_lanes(case):
    _, _, kf, kr, ds, ct = case
    return engine._transient_closures(ds, ct, kf=torch.tensor(np.asarray(kf)),
                                      kr=torch.tensor(np.asarray(kr)))


def _within_last_places(got, want, places):
    """|got - want| <= places * eps * (each lane's largest |want|)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.max(np.abs(want), axis=-1, keepdims=True)
    return float(np.max(np.abs(got - want) / scale / EPS)) <= places


def test_options_and_tableaux_are_the_references():
    assert ode.ODEOptions._fields == jode.ODEOptions._fields
    assert tuple(ode.ODEOptions()) == tuple(jode.ODEOptions())
    for name in ("GAMMA", "D", "B1", "B2", "B3", "BH1", "BH2", "BH3",
                 "E4_D", "E4_A", "E4_B", "E4_BHAT", "_NEWTON_ITERS"):
        assert getattr(ode, name) == getattr(jode, name), name
    assert {k: v[1] for k, v in ode._STEP_FNS.items()} == \
        {k: v[1] for k, v in jode._STEP_FNS.items()}
    assert engine.finish_options(ode.ODEOptions(steady_rel=1e-7)) == \
        tuple(jengine.finish_options(jode.ODEOptions(steady_rel=1e-7)))


@pytest.mark.parametrize("t0,t1,n", [(0.0, 1.0e12, 200), (1.0e-6, 1.0e4, 50),
                                     (0.0, 1.0e8, 19)])
def test_log_time_grid_is_the_references(t0, t1, n):
    """The same grid within 1e-13 relative: XLA's CPU ``pow`` is its own
    approximation, up to 27 units in the last place from numpy's at the
    very same exponents, so no host formula gives its bits."""
    got = ode.log_time_grid(t0, t1, n)
    want = np.asarray(jode.log_time_grid(t0, t1, n))
    assert got.dtype == np.float64 and got.shape == want.shape == (n + 1,)
    assert got[0] == want[0] == 0.0 and np.all(np.diff(got) > 0)
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=0)


def test_full_state_closures_are_the_references(case):
    """Given the JAX package's rate constants: dy/dt, the gross flux and
    the ``jacfwd`` Jacobian bit for bit; ``get_dydt``, ``get_jacobian``
    and ``reaction_rates_at`` (the port's own rate constants, which
    differ from XLA's in the last bits) within 1e-12."""
    sj, cj, kf, kr, ds, ct = case
    y = np.asarray(cj.y0) * np.linspace(0.5, 1.0, sj.n_species)
    yt = torch.tensor(y)
    ops = engine.full_state_operands(ds, ct, torch.tensor(np.asarray(kf)),
                                     torch.tensor(np.asarray(kr)))
    one = lambda c, k1, k2, yy: jengine.make_rhs_and_scale(sj, c, k1, k2)[1](
        yy)
    F, G = jax.jit(jax.vmap(one))(cj, kf, kr, y)
    Fp, Gp = engine._full_rhs(ds, ops, yt, True)
    assert np.array_equal(Fp.numpy(), np.asarray(F))
    assert np.array_equal(Gp.numpy(), np.asarray(G))
    assert torch.equal(engine._full_rhs(ds, ops, yt, False), Fp)
    J = jax.jit(jax.vmap(lambda c, k1, k2, yy: jax.jacfwd(
        jengine.make_rhs(sj, c, k1, k2))(yy)))(cj, kf, kr, y)
    assert np.array_equal(engine.full_jacobian(ds, ops, yt).numpy(),
                          np.asarray(J))
    close = lambda a, b: np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-12, atol=1e-300)
    close(engine.get_dydt(ds, ct, yt),
          jax.vmap(lambda c, yy: jengine.get_dydt(sj, c, yy))(cj, y))
    close(engine.get_jacobian(ds, ct, yt),
          jax.vmap(lambda c, yy: jengine.get_jacobian(sj, c, yy))(cj, y))
    for a, b in zip(engine.reaction_rates_at(ds, ct, yt), jax.vmap(
            lambda c, yy: jengine.reaction_rates_at(sj, c, yy))(cj, y)):
        close(a, b)


@pytest.mark.parametrize("h", [1.0e-10, 1.0e-9, 3.0e-9])
@pytest.mark.parametrize("method", ["trbdf2", "esdirk4"])
def test_one_step_matches_jax(case, method, h):
    """One step attempt of every lane from y0: the new state within two
    units in the last place of each lane's largest entry, the error
    ratio within 1e-9 relative, the step verdict equal."""
    sj, cj, kf, kr, ds, ct = case
    y1, err, ok = _jax_program(case, "step", method)(
        cj, kf, kr, cj.y0, jnp.asarray(h))
    fns = _port_lanes(case)(None)
    step = {"trbdf2": ode._trbdf2_step, "esdirk4": ode._esdirk4_step}[method]
    y1t, errt, okt = step(fns.f, fns.jac, ct.y0, None,
                          torch.full((L,), h, dtype=torch.float64),
                          ode.ODEOptions(method=method))
    assert np.array_equal(okt.numpy(), np.asarray(ok))
    assert bool(okt.all())
    assert _within_last_places(y1t, y1, 2)
    np.testing.assert_allclose(errt.numpy(), np.asarray(err), rtol=1e-9)


@pytest.mark.parametrize("t1", [1.0e-9, 3.0e-7])
@pytest.mark.parametrize("method", ["trbdf2", "esdirk4"])
def test_advance_to_matches_jax(case, method, t1):
    """One adaptive interval from y0 at h0 = 1e-10 with both oracles:
    every lane reaches t1; the last step size within 1e-6 relative (or
    1e-7 t1) and the states within 1e-6 of the rtol 1e-5 / atol 1e-12
    envelope (see the module doc; measured: 6e-8 and 5e-10)."""
    sj, cj, kf, kr, ds, ct = case
    opts = jode.ODEOptions(method=method)
    y, h, ok = _jax_program(case, "advance", method)(
        cj, kf, kr, cj.y0, jnp.asarray(t1))
    ode.reset_counters()
    yt, ht, okt = ode._advance_to(
        _port_lanes(case), ct.y0, torch.zeros(L, dtype=torch.float64), t1,
        torch.full((L,), opts.h0, dtype=torch.float64),
        ode.ODEOptions(method=method))
    assert np.array_equal(okt.numpy(), np.asarray(ok)) and bool(okt.all())
    share = np.abs(yt.numpy() - np.asarray(y)) / (
        1e-12 + 1e-5 * np.abs(np.asarray(y)))
    assert float(share.max()) <= 1e-6
    # The last step may have been the remainder t1 - t, which keeps t's
    # absolute accuracy, not its relative one.
    np.testing.assert_allclose(ht.numpy(), np.asarray(h), rtol=1e-6,
                               atol=1e-7 * t1)
    counts = ode.step_counts()
    steps = counts["accepted"] + counts["rejected"]
    # One sync per batch step plus the exit check; no lane-step is lost.
    assert ode.SYNCS["ode_active"] >= steps // L + 1
    assert counts["accepted"] >= L and counts["rejected"] >= 0


def test_unknown_method_raises(case):
    with pytest.raises(ValueError, match="unknown ODE method"):
        ode._advance_to(_port_lanes(case), case[5].y0,
                        torch.zeros(L, dtype=torch.float64), 1e-9,
                        torch.full((L,), 1e-10, dtype=torch.float64),
                        ode.ODEOptions(method="bdf"))
