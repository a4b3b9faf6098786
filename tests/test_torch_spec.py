"""The port's host-side spec: its synthetic generator reproduces the JAX
package's ``synthetic_system`` field for field, and specs / conditions
carry across between the packages without loss."""

import dataclasses

import numpy as np
import pytest

from pycatkin_tpu.models.synthetic import synthetic_system
from pycatkin_tpu_torch.frontend import spec as tspec
from pycatkin_tpu_torch.models.synthetic import synthetic_spec

CASES = [(24, 32, 0), (12, 14, 7), (18, 24, 0)]


def _fields(spec):
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}


def _assert_same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray):
            assert isinstance(y, np.ndarray), k
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert np.array_equal(x, y), k
        else:
            assert type(x) is type(y) and x == y, (k, x, y)


@pytest.mark.parametrize("n_species,n_reactions,seed", CASES)
def test_synthetic_spec_equals_jax_field_for_field(n_species, n_reactions,
                                                   seed):
    sysj = synthetic_system(n_species, n_reactions, seed=seed)
    spec, base = synthetic_spec(n_species, n_reactions, seed=seed)
    _assert_same(_fields(sysj.spec), tspec.spec_to_arrays(spec))
    cj = sysj.conditions()
    for f in cj._fields:
        a, b = getattr(cj, f), getattr(base, f)
        if isinstance(a, float):
            assert isinstance(b, float) and a == b, f
        else:
            assert np.array_equal(np.asarray(a), b), f


@pytest.mark.parametrize("n_species,n_reactions,seed", CASES)
def test_spec_carries_across_and_back(n_species, n_reactions, seed):
    sj = synthetic_system(n_species, n_reactions, seed=seed).spec
    d = _fields(sj)
    ported = tspec.spec_from_arrays(d)
    back = tspec.spec_to_arrays(ported)
    _assert_same(d, back)
    # Copies, not views: the two specs share no memory.
    assert not np.shares_memory(ported.stoich, sj.stoich)
    assert ported.n_species == sj.n_species
    assert ported.rindex(sj.rnames[-1]) == sj.rindex(sj.rnames[-1])


def test_conditions_carry_across():
    sysj = synthetic_system(12, 14, seed=7)
    cj = sysj.conditions(T=612.5)
    ct = tspec.conditions_from_arrays(cj)
    assert ct.T == 612.5 and isinstance(ct.T, float)
    for f in cj._fields:
        assert np.array_equal(np.asarray(getattr(cj, f)),
                              np.asarray(getattr(ct, f))), f
    as_dict = tspec.conditions_from_arrays(ct._asdict())
    for f in ct._fields:
        assert np.array_equal(np.asarray(getattr(ct, f)),
                              np.asarray(getattr(as_dict, f))), f


def test_spec_from_arrays_rejects_wrong_fields():
    d = tspec.spec_to_arrays(synthetic_spec(12, 14, seed=0)[0])
    with pytest.raises(ValueError, match="missing"):
        tspec.spec_from_arrays({k: v for k, v in d.items() if k != "SR"})
    with pytest.raises(ValueError, match="unknown"):
        tspec.spec_from_arrays(dict(d, bogus=1))
