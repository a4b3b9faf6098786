"""The slice as a whole: the port's ``fused_sweep(device="cpu")`` against
the JAX package's fused sweep program
(``batch._fused_sweep_program(spec, _fast_pass_opts(SolverOptions()),
1e-2, "cpu", True, True)``, 1e-2 being ``sweep_steady_state``'s default
``pos_jac_tol``) on identical data.

Verdict masks (success, quarantined, certified, ambiguous,
negative-TOF) and the diagnostics bundle must be bitwise equal. States,
TOF and activity must fall within the repo's cross-kernel envelope,
rtol 1e-5 / atol 1e-12 (docs/perf_pallas_linalg.md) -- held against the
JAX program with its direction solves routed through its own LU
(``linalg.UNROLL_MAX`` set to 0 for the run), the arithmetic the port's
kernels implement. Against the stock program, which solves the
flagship's n = 21 by Gauss-Jordan, the verdicts still agree bitwise but
the converged states differ by up to ~1e-4 on the flagship (ROADMAP,
Queue C), because PTC stops anywhere inside the residual tolerance."""

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
from pycatkin_tpu_torch.ops import cuda_linalg
from pycatkin_tpu_torch.parallel import batch
from pycatkin_tpu_torch.solvers import newton

L = 8
NAMES = ("res", "quar", "cert", "amb", "tofs", "act", "neg", "telemetry",
         "bundle")
VERDICTS = ("quar", "cert", "amb", "neg", "bundle")


def _jax_sweep(sj, cj, mask):
    jbatch.clear_program_caches()
    try:
        prog = jbatch._fused_sweep_program(
            sj, jbatch._fast_pass_opts(JOptions()), 1e-2, "cpu", True, True)
        keys = jax.random.split(jax.random.PRNGKey(0), L)
        out = prog(cj, keys, None, jnp.asarray(mask))
        return dict(zip(NAMES, jax.device_get(out)))
    finally:
        jbatch.clear_program_caches()


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


@pytest.fixture(scope="module")
def flagship():
    sj, cj, mask = _case(24, 32, 0, (450.0, 650.0))
    return sj, cj, mask, _port_sweep(sj, cj, mask)


@pytest.fixture
def jax_lu_everywhere(monkeypatch):
    """Route every JAX direction solve through its sequential LU (the
    n <= UNROLL_MAX Gauss-Jordan branch disabled) and build its one-shot
    LU without loop unrolling (same arithmetic, faster compile)."""
    monkeypatch.setattr(jlinalg, "UNROLL_MAX", 0)
    monkeypatch.setattr(
        jlinalg, "_lu_solve_once",
        lambda A, b: jlinalg.lu_solve(*jlinalg.lu_factor(A, unroll=1), b,
                                      unroll=1))


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


def test_flagship_matches_jax_lu_route(flagship, jax_lu_everywhere):
    sj, cj, mask, pt = flagship
    pj = _jax_sweep(sj, cj, mask)
    _assert_verdicts_equal(pt, pj)
    _assert_envelope(pt, pj)
    assert np.array_equal(pt["telemetry"][:, 0].numpy(),
                          np.asarray(pj["telemetry"])[:, 0])


def test_certificate_mechanism_matches_jax(jax_lu_everywhere):
    """(12, 14): deflated dimension 8, so every lane's certificate runs
    the 64 x 64 Kronecker solve (``factor_solve`` on a card)."""
    sj, cj, mask = _case(12, 14, 0, (400.0, 800.0))
    newton.reset_syncs()
    pt = _port_sweep(sj, cj, mask)
    assert 0 < newton.SYNCS["ptc_active"] <= 101
    pj = _jax_sweep(sj, cj, mask)
    _assert_verdicts_equal(pt, pj)
    _assert_envelope(pt, pj)
    assert bool(pt["cert"].all())
