"""The port's rate chain against the JAX package on the same inputs: free
energies, reaction energies and rate constants for 8 lanes with T from
400 to 800 K.

Tolerance: rtol 1e-12. Torch and XLA differ by ulps in exp/log and in
the order of the stoichiometric sums; where a quantity is a difference
of nearly equal terms (reaction energies), the absolute floor is 1e-12
of that quantity's largest magnitude across the batch."""

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


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, what
    atol = RTOL * max(float(np.max(np.abs(b))), 1e-300)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol, err_msg=what)


@pytest.fixture(scope="module", params=[(24, 32, 0), (12, 14, 7)],
                ids=["flagship", "small"])
def case(request):
    ns, nr, seed = request.param
    sysj = synthetic_system(ns, nr, seed=seed)
    sj = sysj.spec
    cj = broadcast_conditions(sysj.conditions(), L)._replace(
        T=jnp.linspace(400.0, 800.0, L))
    ds = engine.bind(spec_from_arrays(
        {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)}),
        "cpu")
    ct = engine.conditions_to(conditions_from_arrays(
        {f: np.asarray(getattr(cj, f)) for f in cj._fields}), "cpu")
    return sj, cj, ds, ct


def test_free_energies_match(case):
    sj, cj, ds, ct = case
    fj = jax.vmap(lambda c: jengine.free_energies(sj, c))(cj)
    ft = engine.free_energies(ds, ct)
    for name in fj._fields:
        _close(getattr(ft, name).numpy(), getattr(fj, name), name)


def test_reaction_energies_match(case):
    sj, cj, ds, ct = case
    rj = jax.vmap(lambda c: jengine.reaction_energies(sj, c))(cj)
    rt = engine.reaction_energies(ds, ct)
    for name in rj._fields:
        _close(getattr(rt, name).numpy(), getattr(rj, name), name)


def test_rate_constants_match(case):
    sj, cj, ds, ct = case
    kj = jax.vmap(lambda c: jengine.rate_constants(sj, c))(cj)
    kt = engine.rate_constants(ds, ct)
    for name, a, b in zip(("kf", "kr", "Keq"), kt, kj):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=0.0, err_msg=name)


def test_rate_chain_per_lane_independent(case):
    """A lane's rate constants do not depend on the rest of the batch."""
    _, _, ds, ct = case
    kf = engine.rate_constants(ds, ct)[0]
    one = type(ct)(*(f[3:4] for f in ct))
    assert torch.equal(engine.rate_constants(ds, one)[0], kf[3:4])
