"""The port's analyses against the JAX package's: the energy span model on
seeded landscapes (single and lane-batched) and through ``Energy``, the
uncertainty ensemble (the same noise draws, the ensemble's transients
within the transient envelope), and the grid triage (failure classes,
neighbour repair, the one-lane replay); the plots render headless."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycatkin_tpu.analysis import energy_span as jspan
from pycatkin_tpu.analysis import grid as jgrid
from pycatkin_tpu.analysis.uncertainty import Uncertainty as JUncertainty
from pycatkin_tpu.models.synthetic import synthetic_system as jsynthetic
from pycatkin_tpu.solvers.newton import SteadyStateResults as JResults
from pycatkin_tpu_torch.analysis import energy_span, grid
from pycatkin_tpu_torch.analysis.uncertainty import Uncertainty
from pycatkin_tpu_torch.api import plotting
from pycatkin_tpu_torch.frontend.spec import (conditions_from_arrays,
                                              spec_from_arrays)
from pycatkin_tpu_torch.solvers.newton import SteadyStateResults
from torch_toy import toy

ENV = dict(rtol=1e-5, atol=1e-12)


def _landscapes(L, n, seed):
    rng = np.random.default_rng(seed)
    vals = rng.uniform(-1.5, 1.0, size=(L, n))
    vals[:, 0] = 0.0
    is_ts = np.zeros(n)
    is_ts[1:-1:2] = 1.0
    T = rng.uniform(400.0, 900.0, size=L)
    return vals, is_ts, T


@pytest.mark.parametrize("n,seed", [(5, 0), (9, 1), (12, 2)])
def test_energy_span_model_matches_jax(n, seed):
    """Every output on seeded landscapes to 1e-12 relative (the indices
    exactly), one landscape at a time and as one ``[L, n]`` batch."""
    vals, is_ts, T = _landscapes(6, n, seed)
    want = jax.vmap(lambda v, t: jspan.energy_span_model(
        v, jnp.asarray(is_ts), t))(jnp.asarray(vals), jnp.asarray(T))
    batched = energy_span.energy_span_model(torch.as_tensor(vals), is_ts,
                                            torch.as_tensor(T))
    for i in range(len(T)):
        one = energy_span.energy_span_model(torch.as_tensor(vals[i]),
                                            is_ts, float(T[i]))
        for name, w in zip(want._fields, want):
            for got in (getattr(one, name), getattr(batched, name)[i]):
                got, w_i = got.numpy(), np.asarray(w)[i]
                if name.startswith("i_"):
                    assert int(got) == int(w_i), name
                else:
                    np.testing.assert_allclose(got, w_i, rtol=1e-12,
                                               atol=1e-300, err_msg=name)


@pytest.fixture(scope="module")
def toys():
    return toy("pycatkin_tpu"), toy("pycatkin_tpu_torch", device="cpu")


def test_energy_landscape_matches_jax(toys):
    j, p = toys
    for T in (450.0, 700.0):
        a = p.energy_landscapes["pes"].evaluate_energy_span_model(T, 1e5)
        b = j.energy_landscapes["pes"].evaluate_energy_span_model(T, 1e5)
        assert a[2:4] == b[2:4] and a[6:] == b[6:]
        np.testing.assert_allclose(a[:2], b[:2], rtol=1e-12)
        np.testing.assert_allclose(a[4] + a[5], b[4] + b[5], rtol=1e-12,
                                   atol=1e-300)
        land = p.energy_landscapes["pes"].energy_landscape
        jland = j.energy_landscapes["pes"].energy_landscape
        assert land["isTS"] == jland["isTS"]
        for k in ("free", "electronic"):
            np.testing.assert_allclose(list(land[k].values()),
                                       list(jland[k].values()), rtol=1e-12,
                                       atol=1e-14)


def test_uncertainty_matches_jax(toys):
    """The same correlated noise from ``default_rng(seed)``, and every
    run's transient within the transient envelope of the JAX package's
    batched ensemble; the property statistics follow."""
    j, p = toys
    uj = JUncertainty(j, sigma=0.05, nruns=3, seed=7)
    up = Uncertainty(p, sigma=0.05, nruns=3, seed=7)
    prop = lambda s: float(s.solution[-1][s.spec.sindex("sB")])
    vj, mj, sj = uj.get_mean_property_value(prop)
    vp, mp, sp = up.get_mean_property_value(prop)
    assert up.state_noises == uj.state_noises
    assert sorted(up.noisy_sys) == sorted(uj.noisy_sys) == [0, 1, 2, 3]
    for r in range(4):
        np.testing.assert_allclose(up.noisy_sys[r].solution,
                                   np.asarray(uj.noisy_sys[r].solution),
                                   **ENV, err_msg=f"run {r}")
        assert up.noisy_sys[r].states["sA"].add_to_energy == \
            uj.noisy_sys[r].states["sA"].add_to_energy
    np.testing.assert_allclose(vp, vj, **ENV)
    np.testing.assert_allclose([mp, sp], [mj, sj], rtol=1e-4)


def _results(lanes, n_s, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 0.6, size=(lanes, n_s))
    ok = rng.random(lanes) < 0.5
    res = rng.uniform(0.5, 5.0, size=lanes)
    return x, ok, res


def test_classify_failures_matches_jax():
    sj = jsynthetic(10, 5, seed=0).spec
    x, ok, res = _results(32, sj.n_species, 3)
    labels_j, detail_j = jgrid.classify_failures(
        sj, JResults(x=x, success=ok, residual=res, iterations=None,
                     attempts=None))
    t = torch.as_tensor
    labels, detail = grid.classify_failures(
        sj, SteadyStateResults(x=t(x), success=t(ok), residual=t(res),
                               iterations=None, attempts=None))
    assert list(labels) == list(labels_j) and detail == detail_j
    assert detail["n_failed"] == int((~ok).sum()) > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_average_neighborhood_matches_jax(seed):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((7, 9))
    ok = rng.random((7, 9)) < 0.7
    vals[2, 3] = np.nan
    ok[0:3, 0:3] = False
    out_j, patched_j = jgrid.average_neighborhood(vals, ok)
    out, patched = grid.average_neighborhood(torch.as_tensor(vals),
                                             torch.as_tensor(ok))
    np.testing.assert_array_equal(patched, patched_j)
    np.testing.assert_array_equal(out, out_j)


def test_replay_lane_matches_jax(capsys):
    sysj = jsynthetic(10, 5, seed=0)
    sj = sysj.spec
    cj = jax.tree_util.tree_map(
        lambda a: np.stack([np.asarray(a)] * 3), sysj.conditions())
    cj = cj._replace(T=np.array([450.0, 550.0, 650.0]))
    best_j, rep_j = jgrid.replay_lane(sj, cj, 1)
    sp = spec_from_arrays(
        {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)})
    ct = conditions_from_arrays(
        {f: np.asarray(getattr(cj, f)) for f in cj._fields})
    best, rep = grid.replay_lane(sp, ct, 1, device="cpu")
    assert "replay lane 1 [ptc]" in capsys.readouterr().out
    assert bool(best.success) == bool(best_j.success)
    np.testing.assert_allclose(best.x.numpy(), np.asarray(best_j.x), **ENV)
    assert [t["strategy"] for t in rep["tries"]] == \
        [t["strategy"] for t in rep_j["tries"]]
    for a, b in zip(rep["tries"], rep_j["tries"]):
        assert (a["success"], a["attempts"], a["stable"]) == \
            (b["success"], b["attempts"], b["stable"])
        np.testing.assert_allclose(a["group_sums"], b["group_sums"],
                                   rtol=1e-9)


def test_plots_render_headless(toys, tmp_path):
    pytest.importorskip("matplotlib")
    _, p = toys
    p.times = np.array([0.0, 1e-3, 1.0])
    p.solution = np.tile(p.initial_system, (3, 1))
    plotting.plot_transient(p, path=str(tmp_path))
    plotting.draw_energy_landscape(p.energy_landscapes["pes"], 500.0, 1e5,
                                   path=str(tmp_path))
    grid.convergence_heatmap(np.eye(4) > 0, path=str(tmp_path / "c.png"))
    grid.make_heatmap(np.arange(4.0), np.arange(5.0),
                      np.full((4, 5), 1e-3), path=str(tmp_path / "h.png"))
    names = set(os.listdir(tmp_path))
    assert {"coverages_500.0K_1.0bar.png", "pressures_500.0K_1.0bar.png",
            "free_energy_pes.png", "c.png", "h.png"} <= names
