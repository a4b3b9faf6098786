"""Descriptor-grid triage: failure classification, neighbor repair,
convergence and activity heatmaps (port of
``pycatkin_tpu/analysis/grid.py``).

Descriptor scans routinely leave a few percent of grid points
unconverged; the workflow classifies each failure (site-conservation
violation vs rate residual) from the batched diagnostics of any
mechanism, patches every failed point with the mean of its converged
8-neighbors, re-solves one lane with full diagnostics
(:func:`replay_lane`), and renders pass/fail plus smoothed log-TOF
heatmaps (matplotlib and scipy are imported by the functions that draw).
Results may be device tensors or numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

FAIL_CONSERVATION = "conservation"
FAIL_RATE = "rate"


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def classify_failures(spec, results, coverage_tol: float = 5.0e-2):
    """Classify each failed lane of a batched SteadyStateResults.

    Returns (labels, detail): labels is a [lanes] object array with None
    for converged lanes, else FAIL_CONSERVATION (a site group does not
    sum to ~1) or FAIL_RATE (residual target missed).
    """
    x = _host(results.x)
    ok = _host(results.success).astype(bool)
    res = _host(results.residual)
    sums = x @ np.asarray(spec.groups).T              # [lanes, n_g]
    cons_bad = np.any(np.abs(sums - 1.0) > coverage_tol, axis=-1)
    labels = np.full(ok.shape, None, dtype=object)
    labels[~ok & cons_bad] = FAIL_CONSERVATION
    labels[~ok & ~cons_bad] = FAIL_RATE
    detail = {
        "n_failed": int(np.sum(~ok)),
        "n_conservation": int(np.sum(~ok & cons_bad)),
        "n_rate": int(np.sum(~ok & ~cons_bad)),
        "worst_residual": float(np.max(res[~ok])) if np.any(~ok) else 0.0,
    }
    return labels, detail


def replay_lane(spec, conds, lane: int, x0=None,
                opts=None, strategies=("ptc", "lm"), verbose: bool = True,
                device=None):
    """Re-solve ONE lane of a batched sweep with full diagnostics, for
    interrogating a stubborn point: it runs each strategy in sequence
    from the given (or stored) guess, prints residual, iterations,
    attempts and the per-group coverage sums per strategy, and returns
    the best result.

    conds: the lane-batched Conditions of the sweep; lane: index into
    it. x0: optional [n_dyn] initial guess (e.g. the failed iterate from
    ``results.x``). ``device=None`` solves on the CUDA card; pass
    ``"cpu"`` for the CPU. Returns (SteadyStateResults of the lane,
    0-d fields and ``x [n_s]``, report dict).
    """
    from .. import engine
    from ..parallel.batch import resolve_device
    from ..solvers.newton import SolverOptions, SteadyStateResults

    dev = resolve_device(device)
    opts = opts or SolverOptions()
    ds = engine.bind(spec, dev)
    cond = engine.conditions_to(
        type(conds)(*(_host(a)[lane:lane + 1] for a in conds)), dev)
    groups = np.asarray(spec.groups)
    best, report = None, {"lane": int(lane), "tries": []}
    for strategy in strategies:
        x0t = None if x0 is None else torch.as_tensor(
            _host(x0), dtype=torch.float64, device=dev)[None]
        res = engine.steady_state(ds, cond, x0=x0t, opts=opts,
                                  strategy=strategy)
        stable = (bool(engine.check_stability(ds, cond, res.x)[0])
                  if bool(res.success[0]) else None)
        res = SteadyStateResults(*(None if f is None else f[0]
                                   for f in res))
        y = _host(res.x)
        entry = {
            "strategy": strategy,
            "success": bool(res.success),
            "residual": float(res.residual),
            "iterations": int(res.iterations),
            "attempts": int(res.attempts),
            "group_sums": (groups @ y).tolist(),
            "min_coverage": float(np.min(y[spec.dynamic_indices])),
            "stable": stable,
        }
        report["tries"].append(entry)
        if verbose:
            print(f"replay lane {lane} [{strategy}]: "
                  f"success={entry['success']} "
                  f"residual={entry['residual']:.3e} "
                  f"iters={entry['iterations']} "
                  f"attempts={entry['attempts']} "
                  f"sums={np.round(entry['group_sums'], 6)} "
                  f"min_theta={entry['min_coverage']:.2e} "
                  f"stable={entry['stable']}")
        if best is None or (bool(res.success) and not bool(best.success)):
            best = res
        if bool(res.success):
            break
        x0 = y[spec.dynamic_indices]  # chain strategies
    return best, report


def average_neighborhood(values: np.ndarray, success: np.ndarray):
    """Patch every failed grid point with the mean of its converged
    8-neighborhood. NaN values count as failed. Points with no converged
    neighbor stay unpatched (still flagged failed).

    values: [Ni, Nj]; success: [Ni, Nj] bool.
    Returns (patched_values, patched_mask): patched_mask marks points
    that were repaired.
    """
    values = _host(values).astype(float)
    ok = _host(success).astype(bool) & np.isfinite(values)
    out = values.copy()
    patched = np.zeros_like(ok)
    Ni, Nj = values.shape
    bad = np.argwhere(~ok)
    for i, j in bad:
        i0, i1 = max(i - 1, 0), min(i + 2, Ni)
        j0, j1 = max(j - 1, 0), min(j + 2, Nj)
        nb_ok = ok[i0:i1, j0:j1]
        if np.any(nb_ok):
            out[i, j] = np.mean(values[i0:i1, j0:j1][nb_ok])
            patched[i, j] = True
    return out, patched


def convergence_heatmap(success, x=None, y=None, path=None, ax=None,
                        xlabel=None, ylabel=None):
    """Pass/fail grid image."""
    from ..api.plotting import _pyplot
    plt = _pyplot()
    success = _host(success).astype(float)
    created = ax is None
    if created:
        fig, ax = plt.subplots(figsize=(4, 3.4))
    extent = None
    if x is not None and y is not None:
        extent = [np.min(y), np.max(y), np.min(x), np.max(x)]
    im = ax.imshow(success, origin="lower", extent=extent, aspect="auto",
                   cmap="RdYlGn", vmin=0.0, vmax=1.0)
    ax.set(xlabel=xlabel or "descriptor 2", ylabel=ylabel or "descriptor 1")
    if created:
        fig.colorbar(im, ax=ax).ax.set_ylabel("converged")
        fig.tight_layout()
        if path:
            fig.savefig(path, dpi=300)
        return fig, ax
    return None, ax


def make_heatmap(x, y, panels, labels=None, smooth_sigma: float = 1.0,
                 log_abs: bool = True, path=None, cmap="RdYlBu_r",
                 levels: int = 25, xlabel=None, ylabel=None):
    """Multi-panel Gaussian-smoothed contour maps over a descriptor grid.

    panels: one [Ni, Nj] array or a list of them (e.g. TOF and
    selectivity); ``log_abs`` renders log10|panel|.
    """
    from scipy.ndimage import gaussian_filter

    from ..api.plotting import _pyplot
    plt = _pyplot()

    if isinstance(panels, np.ndarray) and panels.ndim == 2:
        panels = [panels]
    n = len(panels)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 3.4), squeeze=False)
    for k, panel in enumerate(panels):
        z = np.asarray(panel, dtype=float)
        if log_abs:
            z = np.log10(np.maximum(np.abs(z), 1e-300))
        if smooth_sigma:
            z = gaussian_filter(z, sigma=smooth_sigma)
        ax = axes[0, k]
        cs = ax.contourf(np.asarray(y), np.asarray(x), z, levels=levels,
                         cmap=plt.get_cmap(cmap))
        fig.colorbar(cs, ax=ax).ax.set_ylabel(
            (labels or [None] * n)[k] or
            ("log10|value|" if log_abs else "value"))
        ax.set(xlabel=xlabel or "descriptor 2",
               ylabel=ylabel or "descriptor 1")
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=300)
    return fig, axes
