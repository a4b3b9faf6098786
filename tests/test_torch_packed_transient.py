"""The port's packed transient (``parallel.batch.packed_batch_transient``):
K mechanisms of one ABI bucket integrate as one lane batch, and each
tenant's ``(ys, ok)`` is bit for bit its solo ``batch_transient(...,
abi=True)``; against the JAX package's ``packed_batch_transient``
(``PYCATKIN_ABI=1``, its Pallas kernels in interpret mode) ``ok`` is
bitwise and ``ys`` within rtol 1e-5 / atol 1e-12.

The problem is the JAX package's (``tests/test_transient_fused.py``):
synthetic (12, 14) of seed s at T 480-545 K + 2 s, 4 lanes, save grid
``[0] + logspace(-9, -2, 9)``. The port's plain LU versions make a batch
step cost ~40-80 ms on the CPU, and seeds 0, 2 and 3 take 1,000-1,200
steps, so the JAX tests' tenants (seeds 0 .. K-1) run in the ``slow``
cases (~1-4 min each). The default run takes seeds 1 and 4 (59 and 54
steps), whose bucket (S = 32) is the slow cases'.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from pycatkin_tpu import precision
from pycatkin_tpu.frontend import abi as jabi
from pycatkin_tpu.models.synthetic import synthetic_system
from pycatkin_tpu.parallel import batch as jbatch
from pycatkin_tpu_torch.frontend import abi
from pycatkin_tpu_torch.frontend.spec import (conditions_from_arrays,
                                              spec_from_arrays)
from pycatkin_tpu_torch.parallel import batch
from pycatkin_tpu_torch.solvers import ode
from pycatkin_tpu_torch.utils import profiling

LANES = 4
SAVE_TS = np.concatenate([[0.0], np.logspace(-9, -2, 9)])
CHEAP = (1, 4)
ENVELOPE = dict(rtol=1e-5, atol=1e-12)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread is as fast and spares the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(seed, lanes=LANES):
    """The JAX test's tenant ``seed``: ``(jax spec, jax conds, spec,
    conds)``."""
    sim = synthetic_system(n_species=12, n_reactions=14, seed=seed)
    cj = jbatch.broadcast_conditions(sim.conditions(), lanes)._replace(
        T=np.linspace(480.0, 545.0, lanes) + 2.0 * seed)
    sp = spec_from_arrays({f.name: getattr(sim.spec, f.name)
                           for f in dataclasses.fields(sim.spec)})
    cp = conditions_from_arrays(
        {f: np.asarray(getattr(cj, f)) for f in cj._fields})
    return sim.spec, cj, sp, cp


_SOLO = {}


def _solo(seed):
    if seed not in _SOLO:
        _, _, sp, cp = _problem(seed)
        _SOLO[seed] = batch.batch_transient(sp, cp, SAVE_TS, abi=True,
                                            device="cpu")
    return _SOLO[seed]


def _bits(t):
    return t.contiguous().view(torch.int64) if t.is_floating_point() else t


def _assert_bitwise(solo, packed):
    (ys_s, ok_s), (ys_p, ok_p) = solo, packed
    assert ys_s.shape == ys_p.shape and ys_s.dtype == ys_p.dtype
    assert torch.equal(_bits(ys_s), _bits(ys_p))
    assert torch.equal(ok_s, ok_p)


def _packed(seeds, **kw):
    probs = [_problem(s) for s in seeds]
    return batch.packed_batch_transient([p[2] for p in probs],
                                        [p[3] for p in probs], SAVE_TS,
                                        device="cpu", **kw)


def test_one_tenant_takes_its_solo_transient(monkeypatch):
    calls = []
    monkeypatch.setattr(batch, "batch_transient",
                        lambda *a, **kw: calls.append(kw) or "solo")
    _, _, sp, cp = _problem(CHEAP[0])
    assert batch.packed_batch_transient([sp], cp, SAVE_TS,
                                        device="cpu") == ["solo"]
    assert calls == [dict(opts=ode.ODEOptions(), chunk=8, abi=True,
                          device="cpu")]


def test_packed_matches_solo_bitwise():
    ode.reset_counters()
    packed = _packed(CHEAP)
    assert len(packed) == len(CHEAP)
    # One step loop for the pack: the finish picks every tenant's lanes
    # with one sync, and the bundle is one more.
    assert ode.SYNCS["finish_lanes"] == 1
    assert ode.SYNCS["transient_bundle"] == 1
    for seed, p in zip(CHEAP, packed):
        assert bool(p[1].all())
        _assert_bitwise(_solo(seed), p)


@pytest.mark.slow
@pytest.mark.parametrize("k", [1, 2, 4])
def test_packed_matches_solo_bitwise_on_the_jax_tests_tenants(k):
    seeds = tuple(range(k))
    for seed, p in zip(seeds, _packed(seeds)):
        assert bool(p[1].all())
        _assert_bitwise(_solo(seed), p)


@contextlib.contextmanager
def _jax_abi():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(jabi.ABI_ENV, "1")
        mp.setenv(precision.KERNEL_ENV, "pallas")
        mp.setenv("PYCATKIN_AOT_CACHE", "off")
        jbatch.clear_program_caches()
        jabi.clear_lowering_cache()
        try:
            yield
        finally:
            jbatch.clear_program_caches()
            jabi.clear_lowering_cache()


def _against_jax(seeds):
    probs = [_problem(s) for s in seeds]
    with _jax_abi():
        ref = jbatch.packed_batch_transient([p[0] for p in probs],
                                            [p[1] for p in probs], SAVE_TS)
    for (ys_j, ok_j), seed in zip(ref, seeds):
        ys, ok = _solo(seed)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ok_j))
        np.testing.assert_allclose(ys.numpy(), np.asarray(ys_j),
                                   **ENVELOPE)


def test_k2_matches_the_jax_packed_transient():
    # Each packed tenant is its solo run bit for bit (above), so the
    # solo runs stand for the port's pack here.
    _against_jax(CHEAP)


@pytest.mark.slow
def test_k2_matches_the_jax_packed_transient_on_its_tenants():
    _against_jax((0, 1))


def test_poisoned_tenant_is_isolated_and_reported():
    """A NaN initial state on lane 1 of tenant 1 fails that lane without
    moving a bit of tenant 0, and the pack records the non-finite
    endpoint as a ``transient:nonfinite`` degradation event."""
    p0, p1 = _problem(CHEAP[0]), _problem(CHEAP[1])
    y0 = np.array(p1[3].y0)
    y0[1, :] = np.nan
    c1 = p1[3]._replace(y0=y0)
    profiling.drain_events()
    packed = batch.packed_batch_transient([p0[2], p1[2]], [p0[3], c1],
                                          SAVE_TS, device="cpu")
    _assert_bitwise(_solo(CHEAP[0]), packed[0])
    ys1, ok1 = packed[1]
    assert not bool(ok1[1]) and bool(ok1[[0, 2, 3]].all())
    assert not bool(torch.isfinite(ys1[1, -1]).all())
    ev = [e for e in profiling.drain_events()
          if e.get("label") == "transient:nonfinite"]
    assert len(ev) == 1 and ev[0]["lanes"] == 1


def test_packing_rules():
    p = _problem(CHEAP[0])
    assert batch.packed_batch_transient([], [], SAVE_TS, device="cpu") == []
    # Lane counts must agree (checked before anything runs).
    q = _problem(CHEAP[1], lanes=2)
    with pytest.raises(ValueError, match="lane count"):
        batch.packed_batch_transient([p[2], q[2]], [p[3], q[3]], SAVE_TS,
                                     device="cpu")
    # Tenants of different buckets do not pack.
    from pycatkin_tpu_torch.models.synthetic import synthetic_spec
    other, base = synthetic_spec(10, 5, seed=0)
    assert abi.select_static(other).n_species != \
        abi.select_static(p[2]).n_species
    with pytest.raises(abi.AbiBucketError):
        batch.packed_batch_transient(
            [p[2], other],
            [p[3], batch.broadcast_conditions(base, LANES)], SAVE_TS,
            device="cpu")
    with pytest.raises(ValueError, match="2 entries for 3"):
        batch.packed_batch_transient([p[2]] * 3, [p[3]] * 2, SAVE_TS,
                                     device="cpu")
