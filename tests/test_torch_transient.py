"""The port's ``batch_transient`` against the JAX package's on identical
data: synthetic (12, 14) seed 7 (the JAX package's transient problem,
n_s = 24), 4 lanes at T 480-545 K, save grid ``[0] + logspace(-9, -2,
9)``.

- TR-BDF2 and ESDIRK4 unpadded: the stage matrices take the explicit
  Gauss-Jordan inverse in both packages (n_s = 24 <= 48).
- ``abi=True`` against the JAX package under ``PYCATKIN_ABI=1`` with
  its Pallas kernels in interpret mode (``PYCATKIN_LINALG_KERNEL=
  pallas``), as on a TPU: both solve the stage matrices at the bucket's
  S = 32 by ``lu_factor`` + ``lu_solve``, and both average the error
  norms over all S entries, pad species included.
- The LU route at n_s > 48: the flagship mechanism (n_s = 54), 2 lanes,
  grid ``[0, 1e-9, 1e-8, 1e-7, 1e-6]``, TR-BDF2.
- ``ODEOptions(max_steps=5)``: every lane stops short of the first save
  time, so every lane goes through the Newton finish (unpadded and ABI).
- A NaN-poisoned lane ends ``ok = False`` and is counted as
  quarantined in the diagnostics, and leaves its neighbours bit for bit
  as they were; a lane alone is bit for bit the same lane in its batch;
  the finish on the failed lanes alone is the finish on every lane.

``ok`` and the quarantine count must be bitwise equal; ``ys`` within
the repo's cross-kernel envelope, rtol 1e-5 / atol 1e-12, against which
the JAX package moves its own trajectories by at most 5e-9 under a
one-ulp change of T.

Three cases are marked ``slow``: the whole grid through ``abi=True``
(TR-BDF2 and ESDIRK4) and the LU route on the flagship. They take 20 to
65 s each on the CPU, nearly all of it in the plain versions of the LU
kernels, whose substitutions go one row at a time (TR-BDF2: 1,682 steps
of 13 solves at n = 32; the flagship: 819 steps at n = 54), and the
JAX side adds 7 to 24 s. The ABI route stays in the default run through
the finish-path case (S = 32, five steps an interval, then the Newton
finish at D = 8)."""

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycatkin_tpu import precision
from pycatkin_tpu.frontend import abi as jabi
from pycatkin_tpu.models.synthetic import synthetic_system
from pycatkin_tpu.parallel import batch as jbatch
from pycatkin_tpu.solvers import ode as jode
from pycatkin_tpu_torch import engine
from pycatkin_tpu_torch.frontend.spec import (conditions_from_arrays,
                                              spec_from_arrays)
from pycatkin_tpu_torch.ops import cuda_linalg
from pycatkin_tpu_torch.parallel import batch
from pycatkin_tpu_torch.solvers import newton, ode

L = 4
SAVE_TS = np.concatenate([[0.0], np.logspace(-9, -2, 9)])
FLAGSHIP_TS = np.array([0.0, 1e-9, 1e-8, 1e-7, 1e-6])
SHORT = ode.ODEOptions(max_steps=5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Small tensors: one intra-op thread is as fast and spares the other
    test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(ns, nr, seed, lanes, T):
    sysj = synthetic_system(ns, nr, seed=seed)
    cj = jbatch.broadcast_conditions(sysj.conditions(), lanes)._replace(
        T=np.linspace(*T, lanes))
    sp = spec_from_arrays({f.name: getattr(sysj.spec, f.name)
                           for f in dataclasses.fields(sysj.spec)})
    return sysj.spec, cj, sp


def _port_conds(cj):
    return conditions_from_arrays(
        {f: np.asarray(getattr(cj, f)) for f in cj._fields})


@pytest.fixture(scope="module")
def small():
    return _problem(12, 14, 7, L, (480.0, 545.0))


@pytest.fixture(scope="module")
def poisoned(small):
    """Lane 1 of the problem with a NaN initial state."""
    sj, cj, sp = small
    y0 = np.array(cj.y0)
    y0[1, :] = np.nan
    return cj._replace(y0=y0)


@contextlib.contextmanager
def _jax_route(use_abi):
    """The JAX package under ``PYCATKIN_ABI`` and, with it, its Pallas
    kernels in interpret mode (the TPU's routing), with fresh caches."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(jabi.ABI_ENV, "1" if use_abi else "0")
        if use_abi:
            mp.setenv(precision.KERNEL_ENV, "pallas")
        jbatch.clear_program_caches()
        jabi.clear_lowering_cache()
        try:
            yield
        finally:
            jbatch.clear_program_caches()
            jabi.clear_lowering_cache()


_JAX = {}


def _jax(name, sj, cj, save_ts, opts, use_abi=False):
    """The JAX package's ``batch_transient``, once per module and case:
    ``(ys, ok, n_nonfinite_endpoints)`` as numpy."""
    if name not in _JAX:
        with _jax_route(use_abi):
            ys, ok = jbatch.batch_transient(sj, cj, save_ts,
                                            opts=jode.ODEOptions(*opts))
        ys, ok = np.asarray(ys), np.asarray(ok)
        n_quar = int((~np.all(np.isfinite(ys[:, -1]), axis=-1)).sum())
        _JAX[name] = (ys, ok, n_quar)
    return _JAX[name]


_PORT = {}


def _port(sp, cj, save_ts, opts, use_abi=False, name=None):
    """The port's ``batch_transient`` on the CPU: ``(ys, ok,
    diagnostics)`` as numpy and a dict, plus the sync and step counters
    of the run (cached under ``name`` when given)."""
    if name in _PORT:
        return _PORT[name]
    ode.reset_counters()
    newton.reset_syncs()
    cuda_linalg.reset_launches()
    diag = {}
    ys, ok = batch.batch_transient(sp, _port_conds(cj), save_ts, opts=opts,
                                   abi=use_abi, device="cpu",
                                   diagnostics=diag)
    assert set(cuda_linalg.LAUNCHES.values()) == {0}
    assert ode.SYNCS["transient_bundle"] == 1
    counters = dict(ode.SYNCS, **ode.step_counts(),
                    attempts=newton.SYNCS["attempt_active"])
    out = (ys.numpy(), ok.numpy(), diag, counters)
    if name is not None:
        _PORT[name] = out
    return out


def _hold(got, want):
    ys, ok, diag = got[:3]
    ys_j, ok_j, n_quar = want
    assert ys.shape == ys_j.shape and ys.dtype == ys_j.dtype
    assert ok.dtype == ok_j.dtype and np.array_equal(ok, ok_j)
    finite = np.all(np.isfinite(ys[:, -1]), axis=-1)
    assert diag == {"failed": int((~(ok & finite)).sum()),
                    "quarantined": n_quar}
    np.testing.assert_allclose(ys, ys_j, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("method", ["trbdf2", "esdirk4"])
def test_batch_transient_matches_jax(small, method):
    sj, cj, sp = small
    opts = ode.ODEOptions(method=method)
    got = _port(sp, cj, SAVE_TS, opts, name=method)
    assert got[1].all()
    c = got[3]
    assert c["finish_lanes"] == 1
    # One sync per batch step plus each interval's exit check.
    steps = c["accepted"] + c["rejected"] + c["steady"]
    assert len(SAVE_TS) - 1 + steps // L <= c["ode_active"] \
        <= len(SAVE_TS) - 1 + steps
    _hold(got, _jax(method, sj, cj, SAVE_TS, opts))


@pytest.mark.slow
@pytest.mark.parametrize("method", ["trbdf2", "esdirk4"])
def test_abi_transient_matches_jax(small, method):
    """S = 32: the stage solves take ``lu_factor`` + ``lu_solve`` (their
    plain versions on the CPU) in both packages."""
    sj, cj, sp = small
    opts = ode.ODEOptions(method=method)
    got = _port(sp, cj, SAVE_TS, opts, use_abi=True)
    assert got[0].shape == (L, len(SAVE_TS), sj.n_species)
    _hold(got, _jax("abi-" + method, sj, cj, SAVE_TS, opts, use_abi=True))


@pytest.mark.slow
def test_lu_route_matches_jax():
    """The flagship mechanism, n_s = 54 > 48: the LU route in both
    packages, unpadded."""
    sj, cj, sp = _problem(24, 32, 0, 2, (400.0, 800.0))
    assert sj.n_species == 54
    opts = ode.ODEOptions()
    _hold(_port(sp, cj, FLAGSHIP_TS, opts),
          _jax("flagship", sj, cj, FLAGSHIP_TS, opts))


@pytest.mark.parametrize("use_abi", [False, True], ids=["unpadded", "abi"])
def test_finish_path_matches_jax(small, use_abi):
    """Five steps an interval: no lane reaches the first save time, so
    every lane is handed to the Newton finish, which the JAX package
    lets rescue none of them."""
    sj, cj, sp = small
    got = _port(sp, cj, SAVE_TS, SHORT, use_abi=use_abi,
                name=f"short-{use_abi}")
    assert not got[1].any()
    # At most five steps and the exit check an interval.
    assert got[3]["ode_active"] <= (len(SAVE_TS) - 1) * 6
    assert got[3]["attempts"] > 0
    _hold(got, _jax(f"short-{use_abi}", sj, cj, SAVE_TS, SHORT,
                    use_abi=use_abi))


def test_poisoned_lane_is_quarantined_alone(small, poisoned):
    sj, cj, sp = small
    clean = _port(sp, cj, SAVE_TS, SHORT, name="short-False")
    got = _port(sp, poisoned, SAVE_TS, SHORT)
    assert not got[1][1] and got[2]["quarantined"] == 1
    assert not np.isfinite(got[0][1, -1]).all()
    keep = np.array([0, 2, 3])
    assert np.array_equal(got[0][keep], clean[0][keep])
    assert np.array_equal(got[1][keep], clean[1][keep])
    _hold(got, _jax("poisoned", sj, poisoned, SAVE_TS, SHORT))


def test_diagnostics_only_when_asked(small):
    """Without a ``diagnostics`` dict the sweep pulls no bundle, and its
    outputs are those of the run that asked for it."""
    sj, cj, sp = small
    ys_d, ok_d = _port(sp, cj, SAVE_TS, SHORT, name="short-False")[:2]
    ode.reset_counters()
    ys, ok = batch.batch_transient(sp, _port_conds(cj), SAVE_TS, opts=SHORT,
                                   device="cpu")
    assert ode.SYNCS["transient_bundle"] == 0
    assert np.array_equal(ys.numpy(), ys_d) and np.array_equal(ok.numpy(),
                                                               ok_d)


@pytest.mark.parametrize("lane", [0, 2])
def test_lane_alone_matches_its_batch(small, lane):
    """ESDIRK4 over the whole grid, where the lanes leave each interval's
    batch at different steps: a lane run alone has the batch's ``ok`` and
    its states but for BLAS rounding (on the CPU a matmul's sums are
    ordered by its batch size: the reactor's ``net @ S.T`` and the
    inverse's matvec of one lane are not those of four)."""
    sj, cj, sp = small
    opts = ode.ODEOptions(method="esdirk4")
    ys, ok = _port(sp, cj, SAVE_TS, opts, name="esdirk4")[:2]
    alone = cj._replace(**{f: np.asarray(getattr(cj, f))[lane:lane + 1]
                           for f in cj._fields})
    ys1, ok1 = _port(sp, alone, SAVE_TS, opts)[:2]
    assert ok1[0] == ok[lane]
    np.testing.assert_allclose(ys1[0], ys[lane], rtol=1e-9, atol=1e-13)


def test_finish_on_failed_lanes_is_the_finish_on_every_lane(small):
    """The JAX package solves every lane in the finish and keeps the
    solve where ``~ok & good``; the port solves the lanes with ``~ok``
    only. With two lanes ``ok`` and two not, the port's finish equals
    the JAX package's rule applied to a solve of every lane."""
    sj, cj, sp = small
    ds = engine.bind(sp, "cpu")
    ct = engine.conditions_to(_port_conds(cj), "cpu")
    sopts = engine.finish_options(ode.ODEOptions())
    # Steady states, then perturbed: where a lane failed, the finish
    # lands on the attractor again.
    y_last = engine.steady_state(ds, ct, opts=sopts).x * (1.0 + 1e-12)
    ok = torch.tensor([True, False, True, False])
    y_fin, ok_fin = engine.transient_finish(ds, ct, y_last, ok, sopts)
    res = engine.steady_state(ds, ct, x0=y_last[:, ds.dyn], opts=sopts)
    _, _, relaxed = engine._transient_closures(
        ds, ct, steady_rel=sopts.rate_tol_rel)(None).oracles(y_last)
    near = torch.amax(torch.abs(res.x - y_last), dim=-1) <= 5.0e-2
    good = res.success & relaxed & near
    want = torch.where((~ok & good)[:, None], res.x, y_last)
    assert bool(good[~ok].all())
    assert torch.equal(y_fin, want) and torch.equal(ok_fin, ok | good)
    assert torch.equal(y_fin[ok], y_last[ok])
