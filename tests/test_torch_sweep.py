"""The slice as a whole: the port's ``fused_sweep(device="cpu")`` against
the JAX package's fused sweep program
(``batch._fused_sweep_program(spec, _fast_pass_opts(SolverOptions()),
1e-2, "cpu", True, True)``, 1e-2 being ``sweep_steady_state``'s default
``pos_jac_tol``) on identical data, each package on its stock routing
(``linalg.select_solver``): the flagship's n = 21 direction solves by
Gauss-Jordan, the certificate's 64 x 64 Kronecker solves by LU.

Verdict masks (success, quarantined, certified, ambiguous,
negative-TOF) and the diagnostics bundle must be bitwise equal. States,
TOF and activity must fall within the repo's cross-kernel envelope,
rtol 1e-5 / atol 1e-12 (docs/perf_pallas_linalg.md), wherever the
reference itself reproduces to that envelope. On the flagship's
Gauss-Jordan route it does not: the stock JAX program moves its own
converged states by ~1e-4 when T changes by one ulp (its one-shot
Gauss-Jordan direction solves, which the port's take bit for bit, carry
last-bit noise along the march; ROADMAP Queue C). There the port is
held to the envelope with both packages on their LU route, and on the
stock route to twice the reference's own one-ulp spread."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycatkin_tpu import engine as jengine
from pycatkin_tpu.models.synthetic import synthetic_system
from pycatkin_tpu.ops import linalg as jlinalg
from pycatkin_tpu.parallel import batch as jbatch
from pycatkin_tpu.solvers.newton import SolverOptions as JOptions
from pycatkin_tpu_torch.frontend.spec import (conditions_from_arrays,
                                              spec_from_arrays)
from pycatkin_tpu_torch.ops import cuda_linalg, linalg
from pycatkin_tpu_torch.parallel import batch
from pycatkin_tpu_torch.solvers import newton

L = 8
NAMES = ("res", "quar", "cert", "amb", "tofs", "act", "neg", "telemetry",
         "bundle")
VERDICTS = ("quar", "cert", "amb", "neg", "bundle")


def _jax_sweeps(sj, conds, mask):
    """The JAX program on each lane batch of ``conds`` (one compile)."""
    jbatch.clear_program_caches()
    try:
        prog = jbatch._fused_sweep_program(
            sj, jbatch._fast_pass_opts(JOptions()), 1e-2, "cpu", True, True)
        outs = []
        for cj in conds:
            keys = jax.random.split(jax.random.PRNGKey(0), L)
            out = prog(cj, keys, None, jnp.asarray(mask))
            outs.append(dict(zip(NAMES, jax.device_get(out))))
        return outs
    finally:
        jbatch.clear_program_caches()


def _jax_sweep(sj, cj, mask):
    return _jax_sweeps(sj, [cj], mask)[0]


def _port_sweep(sj, cj, mask):
    sp = spec_from_arrays(
        {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)})
    ct = conditions_from_arrays(
        {f: np.asarray(getattr(cj, f)) for f in cj._fields})
    cuda_linalg.reset_launches()
    out = batch.fused_sweep(sp, ct, mask, device="cpu")
    assert set(cuda_linalg.LAUNCHES.values()) == {0}
    return dict(zip(NAMES, out))


def _case(ns, nr, seed, T):
    sysj = synthetic_system(ns, nr, seed=seed)
    sj = sysj.spec
    cj = jbatch.broadcast_conditions(sysj.conditions(), L)._replace(
        T=jnp.linspace(*T, L))
    return sj, cj, jengine.tof_mask_for(sj, [sj.rnames[-1]])


FLAGSHIP = (24, 32, 0, (450.0, 650.0))


@pytest.fixture(scope="module")
def flagship():
    sj, cj, mask = _case(*FLAGSHIP)
    return sj, cj, mask, _port_sweep(sj, cj, mask)


@pytest.fixture
def fast_jax_lu(monkeypatch):
    """The JAX package's one-shot LU solve with its loops not unrolled:
    the same arithmetic as ``_lu_solve_once``, compiled in a fraction of
    the time (the certificate's 64 x 64 Kronecker systems take it)."""
    monkeypatch.setattr(
        jlinalg, "_lu_solve_once",
        lambda A, b: jlinalg.lu_solve(*jlinalg.lu_factor(A, unroll=1), b,
                                      unroll=1))


@pytest.fixture
def lu_everywhere(monkeypatch, fast_jax_lu):
    """Both packages route every non-bucket solve through their LU (the
    n <= UNROLL_MAX Gauss-Jordan branch disabled in each)."""
    monkeypatch.setattr(jlinalg, "UNROLL_MAX", 0)
    monkeypatch.setattr(linalg, "UNROLL_MAX", 0)


def _assert_verdicts_equal(pt, pj):
    assert np.array_equal(pt["res"].success.numpy(),
                          np.asarray(pj["res"].success))
    for name in VERDICTS:
        assert np.array_equal(pt[name].numpy(), np.asarray(pj[name])), name


def _assert_envelope(pt, pj):
    for name, a, b in (("x", pt["res"].x, pj["res"].x),
                       ("tofs", pt["tofs"], pj["tofs"]),
                       ("act", pt["act"], pj["act"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-12, err_msg=name)


def test_outputs_have_the_jax_programs_layout(flagship):
    sj, _, _, pt = flagship
    assert len(pt) == len(NAMES)
    assert pt["res"].x.shape == (L, sj.n_species)
    assert pt["res"].x.dtype == torch.float64
    for name in ("quar", "cert", "amb", "neg"):
        assert pt[name].shape == (L,) and pt[name].dtype == torch.bool
    assert pt["telemetry"].shape == (L, 5)
    assert pt["telemetry"].dtype == torch.int32
    assert pt["bundle"].shape == (5,) and pt["bundle"].dtype == torch.int32
    assert bool(pt["res"].success.all())


def test_flagship_verdicts_match_stock_jax(flagship):
    sj, cj, mask, pt = flagship
    _assert_verdicts_equal(pt, _jax_sweep(sj, cj, mask))


def _x_gap(a, b):
    """(max |a - b|, the same in units of the envelope) of two states."""
    d = np.abs(np.asarray(a) - np.asarray(b))
    return float(d.max()), float(np.max(d / (1e-12 + 1e-5 * np.abs(b))))


def test_flagship_matches_jax_lu_route(lu_everywhere):
    """On the LU route the reference reproduces itself well inside the
    envelope under a one-ulp change of kscale, and the port sits inside
    it too (``pytest -s`` prints both gaps)."""
    sj, cj, mask = _case(*FLAGSHIP)
    pt = _port_sweep(sj, cj, mask)
    ulp = 1.0 + 2.0 ** -52
    pj, pj_ulp = _jax_sweeps(sj, [cj, cj._replace(kscale=cj.kscale * ulp)],
                             mask)
    _assert_verdicts_equal(pt, pj)
    _assert_envelope(pt, pj)
    assert np.array_equal(pt["telemetry"][:, 0].numpy(),
                          np.asarray(pj["telemetry"])[:, 0])
    self_gap = _x_gap(pj_ulp["res"].x, pj["res"].x)
    print(f"LU route: JAX vs JAX with kscale one ulp up {self_gap}, "
          f"port vs JAX {_x_gap(pt['res'].x, pj['res'].x)}")
    assert self_gap[1] <= 1.0


# The port converges to normalized residual <= 1 by its own engine. The
# two engines' residuals agree to rtol 1e-12 of |F| + gross
# (tests/test_torch_network.py), which moves the normalized residual
# |F| / (rate_tol + rate_tol_rel gross) by up to 1e-12 / rate_tol_rel.
RESIDUAL_SLACK = 1e-12 / JOptions().rate_tol_rel


def _jax_normalized_residual(sj, cj, x):
    """The JAX package's convergence measure at full states ``x``
    ``[L, n_s]``, entry by entry: ``|F_i| / (rate_tol + rate_tol_rel *
    gross_i)`` over the dynamic species (``_rnorm`` before its max)."""
    opts = JOptions()

    def one(c, xx):
        kf, kr, _ = jengine.rate_constants(sj, c)
        F, gross = jengine._dynamic_fscale(sj, c, kf, kr)[0](xx)
        return jnp.abs(F) / (opts.rate_tol + opts.rate_tol_rel * gross)
    dyn = np.asarray(sj.dynamic_indices)
    return np.asarray(jax.jit(jax.vmap(one))(cj, jnp.asarray(
        np.asarray(x)[:, dyn])))


@pytest.fixture(scope="module")
def stock_runs(flagship):
    """The stock JAX program on the flagship, then with T up, T down and
    kscale up by one ulp."""
    sj, cj, mask, _ = flagship
    ulp = 1.0 + 2.0 ** -52
    return _jax_sweeps(sj, [
        cj, cj._replace(T=cj.T * ulp), cj._replace(T=cj.T / ulp),
        cj._replace(kscale=cj.kscale * ulp)], mask)


def test_flagship_matches_stock_jax(flagship, stock_runs):
    """Stock routing in both packages (n = 21: Gauss-Jordan). Verdicts,
    bundle and iteration counts are bitwise equal; states, TOF and
    activity lie within twice the spread the stock JAX program shows
    against itself when T or kscale move by one ulp -- a spread that
    is itself far outside the envelope, which this test also pins.

    That bound is one number for every entry, so it says nothing of
    coverages far below it. Entry by entry, the port's state must be a
    steady state by the JAX package's own test: its residual, evaluated
    by the JAX engine, within the solver's tolerance on every dynamic
    species. (A per-entry bound by each entry's own one-ulp spread is no
    standard: the stock program's own one-ulp runs stand up to ~30
    times the other runs' spread on single entries; ``pytest -s``
    prints it.)"""
    sj, cj, mask, pt = flagship
    pj, *spreads = stock_runs
    _assert_verdicts_equal(pt, pj)
    assert np.array_equal(pt["telemetry"].numpy(),
                          np.asarray(pj["telemetry"]))
    for name in ("x", "tofs", "act"):
        get = (lambda d: np.asarray(d["res"].x)) if name == "x" else \
            (lambda d: np.asarray(d[name]))
        ref = get(pj)
        runs = [np.abs(get(d) - ref) for d in spreads]
        gaps = [r.max() for r in runs]
        dev = np.max(np.abs(get(pt) - ref))
        own = max(np.max(r / (np.max(runs[:i] + runs[i + 1:], axis=0)
                              + 1e-12)) for i, r in enumerate(runs))
        print(f"Gauss-Jordan route, {name}: JAX vs JAX with T up, T down, "
              f"kscale up one ulp {[float(g) for g in gaps]}; port vs JAX "
              f"{float(dev)}; the most outlying one-ulp run stands "
              f"{float(own)} times the others' spread on one entry")
        assert dev <= 2.0 * max(gaps), (name, dev, gaps)
    r = _jax_normalized_residual(sj, cj, pt["res"].x)
    print(f"JAX's normalized residual at the port's states: {r.max()}")
    assert np.all(r <= 1.0 + RESIDUAL_SLACK), np.argwhere(r > 1.0)
    # The reference's own one-ulp spread, in units of the envelope.
    assert max(_x_gap(d["res"].x, pj["res"].x)[1] for d in spreads) > 100.0


def test_flagship_gates_catch_a_wrong_state(flagship, stock_runs):
    """What the stock-route gates of the test above can see: each dynamic
    entry of the port's states doubled in turn, on every lane, is caught
    by the maximum bound (twice the largest one-ulp spread) or by the
    JAX engine's convergence test. Together they catch every doubled
    entry of 1e-5 or more; ``pytest -s`` prints the counts."""
    sj, cj, _, pt = flagship
    pj, *spreads = stock_runs
    ref = np.asarray(pj["res"].x)
    bound = 2.0 * max(np.max(np.abs(np.asarray(d["res"].x) - ref))
                      for d in spreads)
    x = pt["res"].x.numpy()
    by_residual = np.zeros((L, len(sj.dynamic_indices)), bool)
    for j, k in enumerate(sj.dynamic_indices):
        xb = x.copy()
        xb[:, k] *= 2.0
        by_residual[:, j] = np.max(_jax_normalized_residual(sj, cj, xb),
                                   axis=-1) > 1.0 + RESIDUAL_SLACK
    xd = x[:, np.asarray(sj.dynamic_indices)]
    by_max = xd > bound
    missed = xd[~(by_residual | by_max)]
    print(f"doubled entries caught by the convergence test "
          f"{int(by_residual.sum())}, by the maximum {int(by_max.sum())}, "
          f"by neither {missed.size} of {xd.size} (largest "
          f"{float(missed.max()) if missed.size else 0.0}, "
          f"{int((missed < 1e-12).sum())} below 1e-12)")
    assert by_residual.sum() > by_max.sum()
    assert np.all(missed < 1e-5), missed


def test_certificate_mechanism_matches_jax(fast_jax_lu):
    """(12, 14): deflated dimension 8, so every lane's certificate runs
    the 64 x 64 Kronecker solve (``factor_solve`` on a card); its n = 9
    direction solves take Gauss-Jordan in both packages."""
    sj, cj, mask = _case(12, 14, 0, (400.0, 800.0))
    newton.reset_syncs()
    pt = _port_sweep(sj, cj, mask)
    assert 0 < newton.SYNCS["ptc_active"] <= 101
    pj = _jax_sweep(sj, cj, mask)
    _assert_verdicts_equal(pt, pj)
    _assert_envelope(pt, pj)
    assert bool(pt["cert"].all())
