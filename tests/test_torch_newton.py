"""The port's single-attempt PTC fast pass and tier-0 Lyapunov certificate
against the JAX package on the same inputs (the multi-attempt solve and
the rescue ladder: ``tests/test_torch_rescue.py``).

The PTC comparison runs the (18, 24) synthetic mechanism (n_dyn = 16,
exactly a Pallas bucket) with the JAX package's direction solves forced
through its Pallas LU kernel in interpret mode -- the arithmetic the
port's kernels and their plain versions implement -- so both packages
walk the same trajectory: verdicts and iteration counts bitwise, states
within rtol 1e-5 / atol 1e-12 (the repo's cross-kernel envelope)."""

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
from pycatkin_tpu.solvers import newton as jnewton
from pycatkin_tpu_torch import engine
from pycatkin_tpu_torch.frontend.spec import (conditions_from_arrays,
                                              spec_from_arrays)
from pycatkin_tpu_torch.parallel import batch
from pycatkin_tpu_torch.solvers import newton

FAST = newton.SolverOptions(max_steps=100, max_attempts=1)
JFAST = jbatch._fast_pass_opts(jnewton.SolverOptions())


def _carry(sysj, L, T):
    sj = sysj.spec
    cj = jbatch.broadcast_conditions(sysj.conditions(), L)._replace(
        T=jnp.asarray(T))
    sp = spec_from_arrays(
        {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)})
    ct = engine.conditions_to(conditions_from_arrays(
        {f: np.asarray(getattr(cj, f)) for f in cj._fields}), "cpu")
    return sj, cj, sp, ct


def test_fast_pass_options_agree():
    assert tuple(FAST) == tuple(JFAST)
    assert tuple(batch.fast_pass_opts(newton.SolverOptions())) == \
        tuple(JFAST)


@pytest.mark.parametrize("chords", [0, 2])
def test_ptc_fast_pass_matches_jax_pallas_lu(monkeypatch, chords):
    """``chords = 2``: the chord re-solves reuse the factorization in both
    packages (the fast pass itself runs with 0)."""
    monkeypatch.setenv(precision.KERNEL_ENV, "pallas")
    monkeypatch.setenv(precision.INTERPRET_ENV, "1")
    sj, cj, sp, ct = _carry(synthetic_system(18, 24, seed=0), 4,
                            np.linspace(450.0, 650.0, 4))
    assert len(sj.dynamic_indices) == 16
    jopts = JFAST._replace(chord_steps=chords)
    rj = jax.jit(jax.vmap(
        lambda c: jengine.steady_state(sj, c, opts=jopts)))(cj)
    newton.reset_syncs()
    rt = engine.steady_state(engine.bind(sp, "cpu"), ct,
                             opts=FAST._replace(chord_steps=chords))
    for name in ("success", "rate_ok", "pos_ok", "sums_ok", "iterations",
                 "attempts"):
        assert np.array_equal(np.asarray(getattr(rj, name)),
                              getattr(rt, name).numpy()), name
    # A chord is kept on a strict residual decrease; near convergence
    # that decrease is at rounding level, so the accepted-chord
    # telemetry may differ by one.
    assert np.max(np.abs(np.asarray(rj.chords) - rt.chords.numpy())) \
        <= min(chords, 1)
    assert bool(rt.success.all())
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-5,
                               atol=1e-12)
    np.testing.assert_allclose(rt.dt_exit.numpy(), np.asarray(rj.dt_exit),
                               rtol=1e-5)
    # One any-lane-active check per iteration plus the exit check.
    assert newton.SYNCS["ptc_active"] == int(rt.iterations.max()) + 1


def test_batched_lanes_equal_their_solo_runs():
    """No arithmetic crosses lanes: finished lanes keep their state while
    the others iterate, and a lane solved alone comes out the same."""
    spec_sys = synthetic_system(12, 14, seed=0)
    _, _, sp, ct = _carry(spec_sys, 3, [430.0, 560.0, 790.0])
    ds = engine.bind(sp, "cpu")
    rb = engine.steady_state(ds, ct, opts=FAST)
    assert len(set(rb.iterations.tolist())) > 1
    for i in range(3):
        one = type(ct)(*(f[i:i + 1] for f in ct))
        r1 = engine.steady_state(ds, one, opts=FAST)
        assert int(r1.iterations[0]) == int(rb.iterations[i])
        assert bool(r1.success[0]) == bool(rb.success[i])
        # Not bitwise on the CPU: BLAS orders a matmul's sums by batch
        # size, so a lane alone rounds differently in the last bits.
        np.testing.assert_allclose(r1.x[0].numpy(), rb.x[i].numpy(),
                                   rtol=1e-9, atol=1e-13)


@pytest.fixture
def fast_jax_lu(monkeypatch):
    """The JAX package's one-shot LU solve with its loops not unrolled:
    the same arithmetic as ``_lu_solve_once``, compiled in a fraction of
    the time (the certificate's 64 x 64 Kronecker systems take it)."""
    monkeypatch.setattr(
        jlinalg, "_lu_solve_once",
        lambda A, b: jlinalg.lu_solve(*jlinalg.lu_factor(A, unroll=1), b,
                                      unroll=1))


def _jax_lyap(Js, Q, tols):
    eps = float(np.finfo(np.float64).eps)
    f = jax.jit(jax.vmap(lambda J, t: jnewton.lyapunov_certified_stable(
        J, Q, t, eps_eff=eps)))
    return np.asarray(f(jnp.asarray(Js), jnp.asarray(tols)))


def test_lyapunov_matches_jax_on_mechanism_jacobians(fast_jax_lu):
    sysj = synthetic_system(12, 14, seed=0)
    T = np.linspace(400.0, 800.0, 8)
    sj, cj, sp, ct = _carry(sysj, 8, T)
    ds = engine.bind(sp, "cpu")
    res = engine.steady_state(ds, ct, opts=FAST)
    J = engine.steady_jacobian(ds, ct, res.x[:, ds.dyn])
    Q = newton.deflation_basis_for_spec(sp)
    assert np.array_equal(Q, jnewton.deflation_basis_for_spec(sj))
    assert Q.shape[1] == 8       # a 64 x 64 Kronecker solve per lane
    scale = torch.amax(torch.abs(J), dim=(-2, -1))
    got = {}
    for pos_tol in (1e-2, -1.0):
        tol = newton.stability_tolerance_from_scale(scale, pos_tol)
        got[pos_tol] = newton.lyapunov_certified_stable(J, Q, tol).numpy()
        want = _jax_lyap(J.numpy(), Q, tol.numpy())
        assert got[pos_tol].dtype == bool
        assert np.array_equal(got[pos_tol], want), (pos_tol, want)
    # At the sweep's threshold the certificate proves some lanes (the
    # sweep ORs it with Gershgorin) and abstains on others.
    assert got[1e-2].any() and not got[1e-2].all()


@pytest.mark.parametrize("m", [3, 6, 8])
def test_lyapunov_matches_jax_on_random_matrices(m, fast_jax_lu):
    rng = np.random.default_rng(m)
    n = m + 1
    Q = np.linalg.qr(rng.standard_normal((n, n)))[0][:, :m]
    Js, tols = [], []
    for i in range(12):
        B = rng.standard_normal((n, n))
        shift = [3.0, 0.5, -0.5, -3.0][i % 4] * np.sqrt(n)
        Js.append(B + shift * np.eye(n) if i % 2 else
                  -(B @ B.T) / n - 0.2 * np.eye(n) + shift * 0.1 * (B - B.T))
        tols.append(1e-2)
    Js, tols = np.asarray(Js), np.asarray(tols)
    got = newton.lyapunov_certified_stable(
        torch.tensor(Js), Q, torch.tensor(tols)).numpy()
    want = _jax_lyap(Js, Q, tols)
    assert np.array_equal(got, want)
    assert got.any() and not got.all()


@pytest.mark.parametrize("use_abi", [False, True], ids=["plain", "abi"])
def test_ptc_march_is_the_references_given_its_rate_constants(use_abi):
    """Synthetic (10, 5), 8 lanes, T 450-650 K (D = 8 under ABI): with the
    JAX package's rate constants in both packages, the port's PTC fast
    pass is bit for bit the JAX package's -- states, residuals, step
    counts and exit pseudo-steps. It needs the net rates and the
    tolerance scale rounded once, as XLA's CPU backend rounds its fused
    multiply-adds; a last-bit difference there grows along the march to
    ~1e-5 in a lane's final residual and exit pseudo-step."""
    from pycatkin_tpu.frontend import abi as jabi
    from pycatkin_tpu_torch.frontend import abi

    sj, cj, sp, ct = _carry(synthetic_system(10, 5, seed=0), 8,
                            np.linspace(450.0, 650.0, 8))
    if use_abi:
        jlow, low = jabi.lower_spec(sj), abi.lower_spec(sp)
        sj, cj = jlow.spec_padded, jlow.pad_conditions(cj)
        sp, ct = low, engine.conditions_to(low.pad_conditions(ct), "cpu")
    kf, kr, _ = jax.jit(jax.vmap(
        lambda c: jengine.rate_constants(sj, c)))(cj)
    groups = jnp.asarray(np.asarray(sj.groups))[:, np.asarray(
        sj.dynamic_indices)]

    def attempt(c, kf1, kr1):
        fs, dyn, yb = jengine._dynamic_fscale(sj, c, kf1, kr1)
        return jnewton._ptc_attempt(fs, jax.jacfwd(lambda z: fs(z)[0]),
                                    yb[dyn], groups, JFAST)
    want = jax.jit(jax.vmap(attempt))(cj, kf, kr)
    ds = engine.bind(sp, "cpu")
    cl = engine.closures(ds, ct, torch.tensor(np.asarray(kf)),
                         torch.tensor(np.asarray(kr)))
    got = newton._ptc_attempt(cl.fscale, cl.jac,
                              cl.y_base[..., ds.dyn].contiguous(),
                              ds.groups_dyn, FAST)
    for name, a, b in zip(("x", "residual", "steps", "dt_exit", "chords"),
                          got, want):
        assert np.array_equal(a.numpy(), np.asarray(b)), name
