"""The f32-polish precision tier of the port against its own float64 sweep
and against the JAX package's tier, on identical data.

Under ``tier="f32-polish"`` the fast pass marches in float32 (the float32
builds of the LU kernels' plain versions here, the kernels on a card),
then takes two float64 Newton polish steps and the float64 verdict. The
tier's contract is the JAX package's (tests/test_precision_tiers.py):
verdict, quarantine and stability masks and the telemetry's strategy
column bitwise equal to the float64 sweep; states within rtol 5e-2 /
atol 1e-12 (two independently converged solutions, ``_Y_TOL``); the
telemetry's tier column 1 on the lanes the first pass accepted and 0 on
every rescue-ladder product. Against the JAX package's tier the same:
verdicts bitwise, states within ``_Y_TOL``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycatkin_tpu import engine as jengine
from pycatkin_tpu import precision as jprecision
from pycatkin_tpu.frontend import abi as jabi
from pycatkin_tpu.models.synthetic import synthetic_system
from pycatkin_tpu.ops import linalg as jlinalg
from pycatkin_tpu.ops import pallas_linalg as plk
from pycatkin_tpu.parallel import batch as jbatch
from pycatkin_tpu.solvers import newton as jnewton
from pycatkin_tpu_torch import engine, precision
from pycatkin_tpu_torch.frontend.spec import (conditions_from_arrays,
                                              spec_from_arrays)
from pycatkin_tpu_torch.ops import cuda_linalg as cl
from pycatkin_tpu_torch.ops import linalg
from pycatkin_tpu_torch.parallel import batch
from pycatkin_tpu_torch.solvers import newton
from pycatkin_tpu_torch.solvers.newton import SolverOptions

N_LANES = 32
_Y_TOL = dict(rtol=5e-2, atol=1e-12)
_TOF_NOISE = 1e-7
MASKS = ("success", "quarantined", "stable", "rate_ok", "pos_ok", "sums_ok")
# x within 1e-12 relative in float64, so 1e-12 eps32 / eps64 in float32.
F32_TOL = 1e-12 * float(np.finfo(np.float32).eps / np.finfo(np.float64).eps)


def _port_spec(sj):
    return spec_from_arrays(
        {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)})


def _port_conds(cj):
    return conditions_from_arrays(
        {f: np.asarray(getattr(cj, f)) for f in cj._fields})


@pytest.fixture(scope="module")
def problem():
    """The JAX tier tests' corpus: synthetic (16, 24) seed 3, 32 lanes, T
    480-620 K, the TOF of the last reaction, the system's options."""
    sim = synthetic_system(n_species=16, n_reactions=24, seed=3)
    sj = sim.spec
    cj = jbatch.broadcast_conditions(sim.conditions(), N_LANES)._replace(
        T=np.linspace(480.0, 620.0, N_LANES))
    mask = np.asarray(jengine.tof_mask_for(sj, [sj.rnames[-1]]))
    opts = SolverOptions(**sim.solver_options()._asdict())
    return sj, cj, _port_spec(sj), _port_conds(cj), mask, opts


def _port_tiers(spec, conds, mask, **kw):
    ref = batch.sweep_steady_state(spec, conds, mask, device="cpu", **kw)
    out = batch.sweep_steady_state(spec, conds, mask, device="cpu",
                                   tier="f32-polish", **kw)
    return ref, out


def _jax_sweep(monkeypatch, sj, cj, mask, tier, use_abi, **kw):
    monkeypatch.setenv(jprecision.TIER_ENV, tier)
    monkeypatch.setenv(jprecision.KERNEL_ENV, "pallas")
    monkeypatch.setenv(jabi.ABI_ENV, "1" if use_abi else "0")
    jbatch.clear_program_caches()
    jabi.clear_lowering_cache()
    try:
        out = jbatch.sweep_steady_state(sj, cj, tof_mask=mask, **kw)
        return {k: np.asarray(v) for k, v in out.items()}
    finally:
        jbatch.clear_program_caches()
        jabi.clear_lowering_cache()


def _assert_tier_equivalent(ref: dict, out: dict):
    """The JAX package's ``_assert_tier_equivalent`` on two of the port's
    sweeps: verdict masks bitwise, the telemetry's strategy column
    bitwise, floats within the envelope, trajectory diagnostics
    (iterations, residual, dt_exit) exempt."""
    assert sorted(ref) == sorted(out)
    for k in sorted(ref):
        a, b = ref[k], out[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k == "lane_telemetry":
            assert torch.equal(a[:, 3], b[:, 3]), "strategy column"
        elif k in ("iterations", "residual", "dt_exit"):
            continue
        elif not a.is_floating_point():
            assert torch.equal(a, b), k
        elif k == "y":
            np.testing.assert_allclose(b.numpy(), a.numpy(), err_msg=k,
                                       **_Y_TOL)
        elif k == "tof":
            np.testing.assert_allclose(b.numpy(), a.numpy(), err_msg=k,
                                       rtol=5e-2, atol=_TOF_NOISE)
        elif k == "activity":
            sig = np.abs(ref["tof"].numpy()) > _TOF_NOISE
            np.testing.assert_allclose(b.numpy()[sig], a.numpy()[sig],
                                       rtol=0, atol=0.1)


def _assert_matches_jax(pt: dict, pj: dict, states: bool = True):
    """The port's tier against the JAX package's: verdict masks and the
    strategy and tier columns bitwise; with ``states``, states within
    ``_Y_TOL``."""
    assert sorted(pt) == sorted(pj)
    for k in MASKS:
        if k in pj:
            assert np.array_equal(pt[k].numpy(), pj[k]), k
    assert np.array_equal(pt["lane_telemetry"][:, 3:].numpy(),
                          pj["lane_telemetry"][:, 3:])
    if states:
        np.testing.assert_allclose(pt["y"].numpy(), pj["y"], **_Y_TOL)


# ----------------------------------------------------------------------
# the tier layer


def test_tier_registry_matches_jax():
    assert precision.TIERS == jprecision.TIERS
    assert precision.TIER_CODES == jprecision.TIER_CODES
    assert precision.TIER_NAMES == jprecision.TIER_NAMES
    assert precision.bulk_dtype("f32-polish") == torch.float32
    assert precision.bulk_dtype("f64") == torch.float64
    assert precision.verify_dtype() == torch.float64
    x = torch.linspace(0.0, 1.0, 5, dtype=torch.float64)
    assert precision.cast_bulk(x, "f32-polish").dtype == torch.float32
    assert precision.cast_bulk(x, "f64") is x
    assert precision.cast_verify(x.float()).dtype == torch.float64


def test_unknown_tier_raises(problem):
    _, _, spec, conds, mask, _ = problem
    with pytest.raises(ValueError, match="unknown precision tier"):
        precision.check_tier("f16")
    with pytest.raises(ValueError, match="unknown precision tier"):
        batch.sweep_steady_state(spec, conds, mask, device="cpu",
                                 tier="f32")
    with pytest.raises(ValueError, match="unknown precision tier"):
        batch.packed_sweep_steady_state([spec, spec], conds, mask,
                                        device="cpu", tier="bf16")


def test_bulk_options_floors_tolerances():
    """The cases of the JAX package's test of the same name."""
    opts = SolverOptions(rate_tol=1e-10, rate_tol_rel=1e-9)
    b = newton.bulk_options(opts, "f32-polish")
    assert b.rate_tol >= 1e-5
    assert b.rate_tol_rel >= 32.0 * float(np.finfo(np.float32).eps)
    loose = SolverOptions(rate_tol=1e-3, rate_tol_rel=1e-2)
    b2 = newton.bulk_options(loose, "f32-polish")
    assert b2.rate_tol == loose.rate_tol
    assert b2.rate_tol_rel == loose.rate_tol_rel
    jb = jnewton.bulk_options(jnewton.SolverOptions(rate_tol=1e-10,
                                                    rate_tol_rel=1e-9),
                              "f32-polish")
    assert (b.rate_tol, b.rate_tol_rel) == (jb.rate_tol, jb.rate_tol_rel)


def test_polish_newton_keeps_only_steps_that_do_not_grow(problem):
    """From a float32 bulk iterate the polish lowers no lane's residual
    bound: each lane ends at most where it began, and where a step would
    raise the residual (a Jacobian of the wrong sign) the lane keeps its
    state bit for bit."""
    _, _, spec, conds, _, opts = problem
    ds = engine.bind(spec, "cpu")
    ct = engine.conditions_to(conds, "cpu")
    kf, kr, _ = engine.rate_constants(ds, ct)
    cl64 = engine.closures(ds, ct, kf, kr)
    fs32, jac32 = engine.bulk_closures(ds, ct, kf, kr, "f32-polish")
    x0 = ct.y0[:, ds.dyn].contiguous()
    g32 = ds.groups_dyn.float()
    xb, fb, _, _, _ = newton._ptc_attempt(
        fs32, jac32, x0.float(), g32, newton.bulk_options(opts,
                                                          "f32-polish"))
    assert xb.dtype == torch.float32 and fb.dtype == torch.float32
    x = xb.double()
    F, gross = cl64.fscale(x)
    f_start = newton._rnorm(F, gross, opts)
    x1, f1 = newton._polish_newton(cl64.fscale, cl64.jac, x, ds.groups_dyn,
                                   opts, newton.POLISH_STEPS)
    assert bool((f1 <= f_start).all())
    assert bool((f1 <= 1.0).all())
    x2, f2 = newton._polish_newton(cl64.fscale,
                                   lambda y: -1e3 * cl64.jac(y), x,
                                   ds.groups_dyn, opts, 1)
    kept = f2 == f_start
    assert bool(kept.any())
    assert torch.equal(x2[kept], x[kept])
    assert bool((f2 <= f_start).all())


@pytest.mark.parametrize("n", [16, 32, 21, 64])
def test_plain_versions_at_float32(n):
    """The kernels' plain versions and the seam's Gauss-Jordan route in
    float32 against the JAX package's float32 Pallas kernels (interpret
    mode) and ``gauss_solve``: perm equal, LU and x within 1e-12 eps32 /
    eps64 relative; lu_solve after lu_factor, factor_solve and
    make_msolve agree."""
    rng = np.random.default_rng(n)
    L = 6
    A = rng.standard_normal((L, n, n)) + 2.0 * n * np.eye(n)
    for i in range(0, L, 2):
        A[i] = A[i][rng.permutation(n)]
    b = rng.standard_normal((L, n))
    A32, b32 = A.astype(np.float32), b.astype(np.float32)
    At, bt = torch.tensor(A32), torch.tensor(b32)
    LU, perm = cl.lu_factor(At)
    x = cl.lu_solve(LU, perm, bt)
    assert LU.dtype == x.dtype == torch.float32
    rel = lambda a, r: float(np.max(np.abs(np.asarray(a) - np.asarray(r)))
                             / np.max(np.abs(np.asarray(r))))
    if n in (16, 32):
        LUj, pj = jax.vmap(plk.lu_factor)(jnp.asarray(A32))
        xj = jax.vmap(plk.lu_solve)(LUj, pj, jnp.asarray(b32))
        assert np.asarray(LUj).dtype == np.float32
        assert np.array_equal(perm.numpy(), np.asarray(pj))
        assert rel(LU, LUj) <= F32_TOL
        assert rel(x, xj) <= F32_TOL
        assert rel(cl.factor_solve(At, bt), xj) <= F32_TOL
    else:
        xj = jax.vmap(jlinalg.gauss_solve)(jnp.asarray(A32),
                                           jnp.asarray(b32))
        assert rel(x, xj) <= F32_TOL
        if n <= linalg.UNROLL_MAX:
            xg = linalg.gauss_solve(At, bt)
            assert xg.dtype == torch.float32
            assert rel(xg, xj) <= F32_TOL
            inv_j = jax.vmap(jlinalg.inv)(jnp.asarray(A32))
            assert rel(linalg.inv(At), inv_j) <= F32_TOL
    assert rel(linalg.make_msolve(At)(bt), x.numpy()) <= F32_TOL
    assert rel(x.double(), np.linalg.solve(A32.astype(np.float64),
                                           b32[..., None].astype(
                                               np.float64))[..., 0]) <= 1e-5


# ----------------------------------------------------------------------
# sweeps


def test_clean_corpus_matches_f64_and_jax(problem, monkeypatch):
    """The JAX tier tests' clean corpus, unpadded: every lane converges
    and is stable under both tiers; the port's f32-polish against its own
    float64 sweep and against the JAX package's f32-polish sweep. The
    tier column is 1 on every lane, as the JAX package's."""
    sj, cj, spec, conds, mask, opts = problem
    ref, out = _port_tiers(spec, conds, mask, opts=opts,
                           check_stability=True)
    assert bool(ref["success"].all())
    _assert_tier_equivalent(ref, out)
    assert bool((ref["lane_telemetry"][:, 4] == 0).all())
    assert bool((out["lane_telemetry"][:, 4] == 1).all())
    jopts = jnewton.SolverOptions(**opts._asdict())
    pj = _jax_sweep(monkeypatch, sj, cj, mask, "f32-polish", False,
                    opts=jopts, check_stability=True)
    _assert_matches_jax(out, pj)
    assert np.array_equal(out["lane_telemetry"][:, 4].numpy(),
                          pj["lane_telemetry"][:, 4])


def test_crippled_pacing_matches_f64_and_jax(problem, monkeypatch):
    """Six PTC steps a pass, two attempts: the float64 fast pass fails
    every lane into the rescue ladder, while the float32 bulk (floored
    tolerances) and the polish accept them first pass, as in the JAX
    package; the final verdicts stay the float64 sweep's and the JAX
    package's tier's, bitwise."""
    sj, cj, spec, conds, mask, _ = problem
    opts = SolverOptions(max_steps=6, max_attempts=2)
    ref, out = _port_tiers(spec, conds, mask, opts=opts,
                           check_stability=True)
    assert bool((ref["lane_telemetry"][:, 3] >= 1).all())
    for k in MASKS:
        assert torch.equal(ref[k], out[k]), k
    np.testing.assert_allclose(out["y"].numpy(), ref["y"].numpy(), **_Y_TOL)
    tel = out["lane_telemetry"]
    assert torch.equal(tel[:, 4], torch.where(
        tel[:, 3] == 0, torch.ones_like(tel[:, 4]),
        torch.zeros_like(tel[:, 4])))
    pj = _jax_sweep(monkeypatch, sj, cj, mask, "f32-polish", False,
                    opts=jnewton.SolverOptions(max_steps=6, max_attempts=2),
                    check_stability=True)
    _assert_matches_jax(out, pj)


def test_polish_failure_falls_through_the_ladder(problem, monkeypatch):
    """With no polish step the raw float32 iterate cannot pass the float64
    verdict, so the lanes go through the (float64) rescue ladder to the
    float64 sweep's verdicts; the tier column is 1 only on lanes the first
    pass accepted, 0 on every ladder product (the failure path's host
    telemetry)."""
    _, _, spec, conds, mask, opts = problem
    ref = batch.sweep_steady_state(spec, conds, mask, opts=opts,
                                   check_stability=True, device="cpu")
    monkeypatch.setattr(newton, "POLISH_STEPS", 0)
    out = batch.sweep_steady_state(spec, conds, mask, opts=opts,
                                   check_stability=True, device="cpu",
                                   tier="f32-polish")
    for k in ("success", "stable", "quarantined"):
        assert torch.equal(ref[k], out[k]), k
    tel = out["lane_telemetry"]
    strat, tcol = tel[:, 3], tel[:, 4]
    assert bool((strat >= 1).any())
    assert torch.equal(tcol, (strat == 0).to(tcol.dtype))


@pytest.mark.parametrize("shape,seed,D", [((16, 24), 3, 16),
                                          ((24, 32), 0, 32)],
                         ids=["16x24-D16", "flagship-D32"])
def test_abi_sweep_matches_f64_and_jax(monkeypatch, shape, seed, D):
    """The ABI route, 8 lanes: the tier corpus's mechanism (D = 16) and
    the flagship (D = 32, the float32 lu_factor / lu_solve's warp tier on
    a card; their plain versions here), against the port's float64 ABI
    sweep and the JAX package's f32-polish ABI sweep (Pallas kernels in
    interpret mode): verdicts and the strategy column bitwise, states
    within ``_Y_TOL`` of the JAX package's tier. On the flagship the
    float32 march ends on another stable steady state than the float64
    one on every lane, in the JAX package as in the port (ROADMAP Queue C
    item 7): there the port's tier must leave the float64 states on
    exactly the lanes where the JAX package's does."""
    sim = synthetic_system(*shape, seed=seed)
    sj = sim.spec
    cj = jbatch.broadcast_conditions(sim.conditions(), 8)._replace(
        T=np.linspace(450.0, 650.0, 8))
    mask = np.zeros(sj.n_reactions)
    mask[-1] = 1.0
    spec, conds = _port_spec(sj), _port_conds(cj)
    ref, out = _port_tiers(spec, conds, mask, abi=True,
                           check_stability=True)
    assert bool(ref["success"].all())
    assert bool((out["lane_telemetry"][:, 4] == 1).all())
    pj = _jax_sweep(monkeypatch, sj, cj, mask, "f32-polish", True,
                    check_stability=True)
    _assert_matches_jax(out, pj)
    pj64 = _jax_sweep(monkeypatch, sj, cj, mask, "f64", True,
                      check_stability=True)
    off = lambda a, r: np.any(np.abs(a - r) > _Y_TOL["atol"]
                              + _Y_TOL["rtol"] * np.abs(r), axis=-1)
    moved = off(pj["y"], pj64["y"])
    assert np.array_equal(off(out["y"].numpy(), ref["y"].numpy()), moved)
    if D == 16:
        assert not moved.any()
        _assert_tier_equivalent(ref, out)
    else:
        assert moved.all()
        for k in MASKS:
            assert torch.equal(ref[k], out[k]), k
        assert torch.equal(ref["lane_telemetry"][:, 3],
                           out["lane_telemetry"][:, 3])


@pytest.mark.slow
def test_large_mechanism_tier_falls_to_the_ladder_in_both_packages(
        monkeypatch):
    """Synthetic (200, 200) through ABI (D = 256), 4 lanes T 400-800 K:
    the float64 fast pass converges every lane, the f32-polish one none,
    and the float64 polish rung rescues them, in the JAX package as in
    the port (ROADMAP Queue C item 7): verdicts equal to float64's and
    between the packages, the strategy and tier columns the JAX
    package's, and the rescued states pass the convergence test. The
    states are not compared across the packages: this mechanism's
    steady states are weakly determined along near-null directions of
    its Jacobian (ROADMAP Queue C item 6), and the rung starts from each
    package's own float32 iterate (XLA and PyTorch round float32
    differently), so both converge ~1e-3 apart on its small coverages.
    ~2.5 min, most of it the JAX package's compiles."""
    sim = synthetic_system(200, 200, seed=0)
    sj = sim.spec
    cj = jbatch.broadcast_conditions(sim.conditions(), 4)._replace(
        T=np.linspace(400.0, 800.0, 4))
    mask = np.asarray(jengine.tof_mask_for(sj, [sj.rnames[-1]]))
    spec, conds = _port_spec(sj), _port_conds(cj)
    ref, out = _port_tiers(spec, conds, mask, abi=True)
    pj = {t: _jax_sweep(monkeypatch, sj, cj, mask, t, True)
          for t in ("f64", "f32-polish")}
    assert bool(ref["success"].all()) and bool(out["success"].all())
    assert bool((ref["lane_telemetry"][:, 3] == 0).all())
    assert np.all(pj["f64"]["lane_telemetry"][:, 3] == 0)
    assert bool((out["lane_telemetry"][:, 3] >= 1).all())
    assert bool((out["lane_telemetry"][:, 4] == 0).all())
    _assert_matches_jax(out, pj["f32-polish"], states=False)
    for k in MASKS:
        if k in ref:
            assert torch.equal(ref[k], out[k]), k
    assert bool((out["residual"] <= 1.0).all())
