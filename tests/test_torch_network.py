"""The port's dynamic residual, gross-flux scale and ``jacfwd`` Jacobian
against the JAX package's ``engine._dynamic_fscale`` and
``jax.jacfwd`` on the same inputs, the Jacobian also against the port's
closed form, and the pad-slot semantics ``F = -x`` of
``engine.py:263-276``.

Tolerance: rtol 1e-12. The residual is a net of large gross fluxes, so
its absolute floor is 1e-12 of the gross scale of the same entry; the
Jacobian's is 1e-12 of the lane's largest entry (torch and XLA order
the stoichiometric sums differently)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycatkin_tpu import engine as jengine
from pycatkin_tpu.models.synthetic import synthetic_system
from pycatkin_tpu.parallel.batch import broadcast_conditions
from pycatkin_tpu_torch import engine
from pycatkin_tpu_torch.frontend.spec import (conditions_from_arrays,
                                              spec_from_arrays)

RTOL = 1e-12
L = 8


@pytest.fixture(scope="module", params=[(24, 32, 0), (12, 14, 0)],
                ids=["flagship", "small"])
def case(request):
    ns, nr, seed = request.param
    sysj = synthetic_system(ns, nr, seed=seed)
    sj = sysj.spec
    cj = broadcast_conditions(sysj.conditions(), L)._replace(
        T=jnp.linspace(400.0, 800.0, L))
    sp = spec_from_arrays(
        {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)})
    ct = engine.conditions_to(conditions_from_arrays(
        {f: np.asarray(getattr(cj, f)) for f in cj._fields}), "cpu")
    n_dyn = len(sj.dynamic_indices)
    x = np.random.default_rng(11).uniform(0.0, 0.2, (L, n_dyn))
    return sj, cj, sp, ct, x


def _jax_eval(sj, cj, x):
    def one(c, xx):
        kf, kr, _ = jengine.rate_constants(sj, c)
        fs, _, _ = jengine._dynamic_fscale(sj, c, kf, kr)
        F, g = fs(xx)
        return F, g, jax.jacfwd(lambda z: fs(z)[0])(xx)
    out = jax.jit(jax.vmap(one))(cj, jnp.asarray(x))
    return [np.asarray(a) for a in out]


def _port_eval(ds, ct, x):
    kf, kr, _ = engine.rate_constants(ds, ct)
    cl = engine.closures(ds, ct, kf, kr)
    xt = torch.tensor(x, dtype=torch.float64)
    F, g = cl.fscale(xt)
    return F.numpy(), g.numpy(), cl.jac(xt).numpy()


def test_residual_and_gross_match(case):
    sj, cj, sp, ct, x = case
    Fj, gj, _ = _jax_eval(sj, cj, x)
    Ft, gt, _ = _port_eval(engine.bind(sp, "cpu"), ct, x)
    np.testing.assert_allclose(gt, gj, rtol=RTOL, atol=0.0)
    assert np.all(np.abs(Ft - Fj) <= RTOL * (np.abs(Fj) + gj))


def test_jacfwd_jacobian_matches_jax_and_closed_form(case):
    sj, cj, sp, ct, x = case
    _, _, Jj = _jax_eval(sj, cj, x)
    ds = engine.bind(sp, "cpu")
    _, _, Jt = _port_eval(ds, ct, x)
    Jc = engine.closed_form_jacobian(
        ds, ct, torch.tensor(x, dtype=torch.float64)).numpy()
    assert Jt.shape == (L, x.shape[1], x.shape[1])
    scale = np.max(np.abs(Jj), axis=(1, 2))[:, None, None]
    assert np.all(np.abs(Jt - Jj) <= RTOL * (np.abs(Jj) + scale))
    assert np.all(np.abs(Jt - Jc) <= RTOL * (np.abs(Jc) + scale))


def test_steady_jacobian_matches_jax(case):
    sj, cj, sp, ct, x = case
    jac = jax.jit(jax.vmap(
        lambda c, xx: jengine.steady_jacobian(sj, c, xx)))
    Jj = np.asarray(jac(cj, jnp.asarray(x)))
    Jt = engine.steady_jacobian(engine.bind(sp, "cpu"), ct,
                                torch.tensor(x)).numpy()
    scale = np.max(np.abs(Jj), axis=(1, 2))[:, None, None]
    assert np.all(np.abs(Jt - Jj) <= RTOL * (np.abs(Jj) + scale))


def test_pad_slots_are_decoupled(case):
    """Dynamic slots masked out by ``dyn_mask`` carry ``F = -x`` and a
    gross scale of 1, real slots are untouched, and the Jacobian is
    ``blkdiag(J_real, -I)`` -- as the JAX package pads them."""
    sj, cj, sp, ct, x = case
    n_dyn = x.shape[1]
    mask = np.ones(n_dyn)
    mask[-2:] = 0.0
    F0, g0, _ = _port_eval(engine.bind(sp, "cpu"), ct, x)
    Ft, gt, Jt = _port_eval(engine.bind(sp, "cpu", dyn_mask=mask), ct, x)
    assert np.array_equal(Ft[:, -2:], -x[:, -2:])
    assert np.array_equal(gt[:, -2:], np.ones((L, 2)))
    assert np.array_equal(Ft[:, :-2], F0[:, :-2])
    assert np.array_equal(gt[:, :-2], g0[:, :-2])
    assert np.array_equal(Jt[:, -2:, :], np.broadcast_to(
        -np.eye(n_dyn)[-2:], (L, 2, n_dyn)))

    sj_pad = dataclasses.replace(sj)
    object.__setattr__(sj_pad, "dyn_mask", jnp.asarray(mask))
    Fj, gj, _ = _jax_eval(sj_pad, cj, x)
    assert np.array_equal(Fj[:, -2:], Ft[:, -2:])
    np.testing.assert_allclose(gt, gj, rtol=RTOL, atol=0.0)
    assert np.all(np.abs(Ft - Fj) <= RTOL * (np.abs(Fj) + gj))
