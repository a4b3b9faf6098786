"""Degree of rate control: the port's ``engine.drc`` / ``drc_fd`` /
``make_steady_x`` against the JAX package's on identical data.

The JAX side runs as ``presets._drc_program`` does, ``jit(vmap(...))``
over lanes; the port takes the lane batch directly. ``drc`` is held on
each route of the solve seam: Gauss-Jordan (synthetic (10, 5), n_dyn =
5), the LU route (the same mechanism with both packages' ``UNROLL_MAX``
at 0: the plain ``factor_solve`` here, the JAX package's XLA LU) and a
kernel bucket size (synthetic (18, 24), n_dyn = 16, the TOF of its
first adsorption step, whose last reaction carries no flux: the plain
versions here, the JAX package's Pallas kernels in interpret mode under
``PYCATKIN_LINALG_KERNEL=pallas``). xi must lie within rtol 1e-6 / atol
1e-9, else within twice the JAX package's own spread under a one-ulp
change of T or kscale; ``pytest -s`` prints the gaps."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycatkin_tpu import engine as jengine
from pycatkin_tpu import precision
from pycatkin_tpu.models.synthetic import synthetic_system
from pycatkin_tpu.ops import linalg as jlinalg
from pycatkin_tpu.parallel import batch as jbatch
from pycatkin_tpu_torch import engine
from pycatkin_tpu_torch.frontend.spec import (conditions_from_arrays,
                                              spec_from_arrays)
from pycatkin_tpu_torch.ops import cuda_linalg, linalg

L = 4
RTOL, ATOL = 1e-6, 1e-9
ULP = 1.0 + 2.0 ** -52


def _case(ns, nr):
    sysj = synthetic_system(ns, nr, seed=0)
    sj = sysj.spec
    cj = jbatch.broadcast_conditions(sysj.conditions(), L)._replace(
        T=jnp.linspace(450.0, 650.0, L))
    sp = spec_from_arrays(
        {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)})
    ct = conditions_from_arrays(
        {f: np.asarray(getattr(cj, f)) for f in cj._fields})
    return sj, cj, engine.bind(sp, "cpu"), engine.conditions_to(ct, "cpu")


def _one_ulp(c):
    return (c._replace(T=c.T * ULP), c._replace(T=c.T / ULP),
            c._replace(kscale=c.kscale * ULP))


def _hold(name, got, want, runs):
    """``got`` within the envelope of ``want``, else within twice the
    spread of the reference's one-ulp ``runs`` around it."""
    got, want = np.asarray(got), np.asarray(want)
    gap = float(np.max(np.abs(got - want)))
    frac = float(np.max(np.abs(got - want) / (ATOL + RTOL * np.abs(want))))
    spread = max(float(np.max(np.abs(np.asarray(r) - want))) for r in runs)
    print(f"{name}: max gap {gap:.3e} ({frac:.3g} of the envelope), the "
          f"JAX package's one-ulp spread {spread:.3e}")
    assert frac <= 1.0 or gap <= 2.0 * spread, (name, gap, frac, spread)


def _jax_drc(sj, terms):
    return jax.jit(jax.vmap(lambda c: jengine.drc(sj, c, terms)))


@pytest.fixture
def lu_everywhere(monkeypatch):
    """Both packages route every non-bucket solve through their LU (the
    n <= UNROLL_MAX Gauss-Jordan branch disabled in each)."""
    monkeypatch.setattr(jlinalg, "UNROLL_MAX", 0)
    monkeypatch.setattr(linalg, "UNROLL_MAX", 0)


@pytest.mark.parametrize("route", ["gauss", "lu", "pallas"])
def test_drc_matches_jax(route, request, monkeypatch):
    shape, term = ((18, 24), "ads000") if route == "pallas" else \
        ((10, 5), "r002")
    if route == "lu":
        request.getfixturevalue("lu_everywhere")
    if route == "pallas":
        monkeypatch.setenv(precision.KERNEL_ENV, "pallas")
    sj, cj, ds, ct = _case(*shape)
    n_dyn = len(sj.dynamic_indices)
    assert linalg.select_solver(n_dyn).path == route
    prog = _jax_drc(sj, [term])
    want = prog(cj)
    runs = [prog(c) for c in _one_ulp(cj)]
    cuda_linalg.reset_launches()
    got = engine.drc(ds, ct, [term])
    assert got.shape == (L, sj.n_reactions)
    assert np.all(np.isfinite(got.numpy()))
    _hold(f"drc {route} (n_dyn = {n_dyn})", got.numpy(), want, runs)


def test_steady_x_gradient_in_T_matches_jax():
    """``make_steady_x``'s adjoint differentiates every field: the
    gradient of a weighted sum of x* with respect to T, against
    ``jax.grad`` through the JAX package's ``xstar``."""
    sj, cj, ds, ct = _case(10, 5)
    wv = np.random.default_rng(0).standard_normal(len(sj.dynamic_indices))

    def one(c):
        xstar = jengine.make_steady_x(sj)
        return jax.grad(lambda T: jnp.sum(wv * xstar(c._replace(T=T))))(c.T)
    prog = jax.jit(jax.vmap(one))
    want = prog(cj)
    runs = [prog(c) for c in _one_ulp(cj)]
    T = ct.T.clone().requires_grad_(True)
    x = engine.make_steady_x(ds)(ct._replace(T=T))
    (got,) = torch.autograd.grad((x * torch.as_tensor(wv)).sum(), T)
    assert np.any(np.asarray(want) != 0.0)
    _hold("d(w . x*)/dT", got.numpy(), want, runs)


def test_drc_fd_matches_jax():
    sj, cj, ds, ct = _case(10, 5)
    terms = [sj.rnames[-1]]
    prog = jax.jit(jax.vmap(lambda c: jengine.drc_fd(
        sj, c, terms, return_success=True)))
    want, ok_j = prog(cj)
    runs = [prog(c)[0] for c in _one_ulp(cj)]
    got, ok = engine.drc_fd(ds, ct, terms)
    assert np.array_equal(ok.numpy(), np.asarray(ok_j))
    assert bool(ok.all())
    _hold("drc_fd", got.numpy(), want, runs)


def test_sum_rule():
    """Scaling every rate constant scales the infinite-dilution TOF by
    the same factor, so sum_r xi_r = 1: to 1e-6 for the implicit DRC,
    to 1e-5 for the finite-difference one (a central difference at eps
    = 1e-3 drops O(eps^2) curvature terms per step; 4.8e-6 on the
    coldest lane here)."""
    sj, _, ds, ct = _case(10, 5)
    terms = [sj.rnames[-1]]
    xi = engine.drc(ds, ct, terms)
    xf, ok = engine.drc_fd(ds, ct, terms)
    assert bool(ok.all())
    print(f"sum rule: implicit {float((xi.sum(1) - 1).abs().max()):.3e}, "
          f"fd {float((xf.sum(1) - 1).abs().max()):.3e}")
    assert float((xi.sum(1) - 1.0).abs().max()) <= 1e-6
    assert float((xf.sum(1) - 1.0).abs().max()) <= 1e-5


def test_zero_tof_lane_leaves_its_neighbours():
    """A lane whose TOF is exactly 0 (the TOF step switched off by
    kscale 0) has a non-finite xi; its neighbours' xi stay finite and
    within 1e-12 relative of a run without it."""
    sj, _, ds, ct = _case(10, 5)
    terms = [sj.rnames[-1]]
    j = sj.rindex(terms[0])
    ks = ct.kscale.clone()
    ks[1, j] = 0.0
    xi = engine.drc(ds, ct._replace(kscale=ks), terms)
    assert not bool(torch.isfinite(xi[1]).all())
    keep = torch.tensor([0, 2, 3])
    alone = engine.drc(ds, engine.lane_subset(ct, keep), terms)
    assert bool(torch.isfinite(xi[keep]).all())
    scale = float(alone.abs().max())
    assert float((xi[keep] - alone).abs().max()) <= 1e-12 * scale


# The flagship lane whose FD DRC the card ends not ok (chip_smoke.py
# phase 13c, lane 256 of 65,536 at T 400-800 K), and its converged state
# from the card's phase-3 sweep, as float.hex.
EDGE_LANE_X0 = (
    "0x1.eca3f7f608f99p-19", "0x1.d2e48a7364bdep-1", "0x1.af9718b684c45p-59",
    "0x1.3e540f5f9cfcfp-13", "0x1.59cfb4c2e4f25p-52", "0x1.439820473443dp-25",
    "0x1.4652d78c97b59p-44", "0x1.f7e13e2940a5dp-41", "0x1.4f71bc28a24ddp-45",
    "0x1.1d28ded09d335p-26", "0x1.aa960bb4f2fbcp-52", "0x1.ca4d008905c12p-27",
    "0x1.a398305e9db60p-30", "0x1.68387d8ca23f1p-4", "0x1.d3c4160f5b45bp-53",
    "0x1.2e0a3052ae036p-58", "0x1.1c506292fecd1p-51", "0x1.3f7d8da54dfe1p-43",
    "0x1.a0691b682be52p-27", "0x1.5b8cd24176a90p-24", "0x1.f896c5f27f6d6p-59")


@pytest.mark.slow
def test_drc_fd_edge_lane_flips_within_one_ulp_in_the_reference():
    """The FD DRC lane that ends not ok on the card (ROADMAP Queue C item
    6): from the card's state the JAX package ends it not ok too, and ok
    with kscale up by one ulp -- the verdict of this lane is not a
    property of the port. The port on the CPU ends it ok."""
    sysj = synthetic_system(24, 32, seed=0)
    sj = sysj.spec
    T = np.linspace(400.0, 800.0, 65536)[256]
    c = jbatch.broadcast_conditions(sysj.conditions(), 1)._replace(
        T=np.array([T]))
    cj = type(c)(*(np.concatenate(f) for f in zip(c, _one_ulp(c)[2])))
    x0 = np.array([float.fromhex(h) for h in EDGE_LANE_X0])
    terms = [sj.rnames[-1]]
    _, ok_j = jax.jit(jax.vmap(lambda c, x: jengine.drc_fd(
        sj, c, terms, x0=x, return_success=True)))(
            cj, np.broadcast_to(x0, (2, x0.size)))
    assert np.asarray(ok_j).tolist() == [False, True]
    sp = spec_from_arrays(
        {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)})
    ct = engine.conditions_to(conditions_from_arrays(
        {f: np.asarray(getattr(c, f)) for f in c._fields}), "cpu")
    _, ok = engine.drc_fd(engine.bind(sp, "cpu"), ct, terms,
                          x0=torch.as_tensor(x0[None]))
    assert ok.tolist() == [True]
