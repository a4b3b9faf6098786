"""The port's ``System`` facade against the JAX package's, on the toy
mechanism of ``tests/torch_toy.py`` built with each package's own
classes, and ``synthetic_system`` against the JAX package's.

Tables to 1e-12 relative; the transient (the port's one-lane fused
transient against the JAX package's ``transient_chunked``) and the
steady states within the transient envelope, rtol 1e-5 / atol 1e-12;
DRC within rtol 1e-6 / atol 1e-9. The presets are held in
``tests/test_torch_presets.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pycatkin_tpu import engine as jengine
from pycatkin_tpu.api import presets as jpresets
from pycatkin_tpu.models.synthetic import synthetic_system as jsynthetic
from pycatkin_tpu_torch.api import presets
from pycatkin_tpu_torch.models.synthetic import synthetic_system
from torch_toy import TOF, toy

ENV = dict(rtol=1e-5, atol=1e-12)
DRC = dict(rtol=1e-6, atol=1e-9)


@pytest.fixture(scope="module")
def pair():
    """(JAX system, port system), each after its own solve_odes."""
    j, p = toy("pycatkin_tpu"), toy("pycatkin_tpu_torch", device="cpu")
    j.solve_odes()
    p.solve_odes()
    return j, p


def _close(a, b, name, rtol, atol):
    np.testing.assert_allclose(np.asarray(a, dtype=float),
                               np.asarray(b, dtype=float), rtol=rtol,
                               atol=atol, err_msg=name)


def test_tables_match_jax(pair):
    j, p = pair
    for T in (None, 650.0):
        for name, a, b in (("free", p.free_energy_table(T=T),
                            j.free_energy_table(T=T)),
                           ("reaction", p.reaction_energy_table(T=T),
                            j.reaction_energy_table(T=T)),
                           ("rates", p.rate_constant_table(T=T),
                            j.rate_constant_table(T=T))):
            for k, (x, y) in enumerate(zip(a, b)):
                _close(x, y, f"{name}[{k}] T={T}", 1e-12, 0.0)
    assert p.states["sA"].Gfree_computed == pytest.approx(
        j.states["sA"].Gfree_computed, rel=1e-12)
    y = p.initial_system + 0.01
    for name in ("get_dydt", "get_jacobian", "reaction_terms"):
        _close(getattr(p, name)(y), getattr(j, name)(y), name, 1e-12,
               1e-300)


def test_solve_odes_matches_jax(pair):
    j, p = pair
    # XLA's pow (the JAX package's logspace) is not glibc's.
    _close(p.times, j.times, "times", 1e-13, 0.0)
    assert p.solution.shape == j.solution.shape
    _close(p.solution, j.solution, "solution", **ENV)


def test_find_steady_matches_jax(pair):
    j, p = pair
    rj, rp = j.find_steady(), p.find_steady()
    assert bool(rp.success) == bool(rj.success) is True
    _close(rp.x, rj.x, "x", **ENV)
    _close(p.full_steady, j.full_steady, "full_steady", **ENV)


@pytest.mark.parametrize("mode", ["implicit", "fd"])
def test_degree_of_rate_control_matches_jax(pair, mode):
    """The facade's DRC against the JAX package's engine as its System
    calls it (from its own transient's last state), under ``jit``."""
    j, p = pair
    x0 = jnp.asarray(j.solution[-1][j.spec.dynamic_indices])
    cond = j.conditions()
    if mode == "implicit":
        want = jax.jit(lambda c, x: jengine.drc(
            j.spec, c, TOF, x0=x, opts=j.solver_options()))(cond, x0)
    else:
        want, ok = jax.jit(lambda c, x: jengine.drc_fd(
            j.spec, c, TOF, x0=x, return_success=True))(cond, x0)
        assert bool(ok)
    got = p.degree_of_rate_control(TOF, mode=mode)
    assert list(got) == list(j.spec.rnames)
    _close(list(got.values()), want, f"drc {mode}", **DRC)
    assert sum(got.values()) == pytest.approx(1.0, abs=1e-5)


def test_activity_and_tof_match_jax(pair):
    j, p = pair
    assert p.activity(TOF) == pytest.approx(j.activity(TOF), rel=1e-9)
    assert presets.get_tof_for_given_reactions(p, TOF) == pytest.approx(
        jpresets.get_tof_for_given_reactions(j, TOF), rel=1e-5)


def test_synthetic_system_matches_jax():
    """``synthetic_system`` builds the JAX package's mechanism: the spec
    field for field and the conditions bitwise."""
    sp = synthetic_system(12, 14, seed=3, device="cpu")
    sj = jsynthetic(12, 14, seed=3)
    assert sp.params == sj.params
    for f in dataclasses.fields(sj.spec):
        a, b = getattr(sp.spec, f.name), getattr(sj.spec, f.name)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert tuple(a) == tuple(b) if isinstance(b, (list, tuple)) \
                else a == b, f.name
    for name, a, b in zip(sj.conditions()._fields, sp.conditions(),
                          sj.conditions()):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=name)
