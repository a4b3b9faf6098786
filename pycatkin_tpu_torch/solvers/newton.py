"""Steady-state solver: pseudo-transient continuation over a lane batch
(PyTorch port of ``pycatkin_tpu/solvers/newton.py``): the PTC and
projected Levenberg-Marquardt attempts, the single-attempt fast pass and
the general multi-attempt solve with random restarts, plus the verdicts,
the packed telemetry and the tier-0 Lyapunov stability certificate.

One PTC attempt solves ``(I/dt - J) dx = F(x)``, ``x += dx``, with ``dt``
adapted by the ratio of successive residual norms; ``dt -> inf``
recovers Newton. Under the ``"f32-polish"`` precision tier the fast pass
marches in float32 and polishes in float64 (:func:`solve_steady`). The
JAX package runs it as ``vmap(lax.while_loop)``; here it is one loop
over all lanes with an active mask, which is exactly
that batching rule: every iteration computes the body for every lane and
keeps the old state (``x``, ``F``, ``dt``, ``fnorm``, ``k``, the chord
counter) where a lane is done. No arithmetic crosses lanes. Deciding on
the host whether any lane is still active is one device-to-host sync per
iteration, counted in :data:`SYNCS`. The multi-attempt loop is the same
batching rule one level up; it runs each attempt on the lanes still
failing only, which changes no lane's result.

A packed multi-tenant batch (``parallel.batch.packed_sweep_steady_state``)
runs K mechanisms' lanes as one batch, tenant-major: its ``groups_dyn``
is stacked ``[K, n_g, n]``, and every operation that reads the groups
(the projection, the conservation rows, the verdict) takes each tenant's
lanes with its own groups, in the same operations at the same shapes as
that tenant's solo batch, so each lane's arithmetic is its solo run's.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import precision
from ..ops import linalg, prng

#: Device-to-host syncs spent by the batched loops since the last
#: :func:`reset_syncs`: one per PTC or LM iteration plus each loop's
#: exit check, one per attempt of the multi-attempt loop, and one per
#: diagnostics bundle a sweep pulls (``parallel.batch``).
SYNCS = {"ptc_active": 0, "lm_active": 0, "attempt_active": 0,
         "sweep_bundle": 0}


def reset_syncs() -> None:
    for k in SYNCS:
        SYNCS[k] = 0


class SteadyStateResults(NamedTuple):
    """Steady-state solution + per-lane diagnostics, each with a leading
    lane dimension: ``x`` the full state, ``success`` the verdict,
    ``residual`` the normalized residual, ``iterations`` / ``attempts``
    the work spent, ``rate_ok`` / ``pos_ok`` / ``sums_ok`` the verdict's
    three tests at the returned iterate, ``dt_exit`` the pseudo-step the
    attempt exited with and ``chords`` the accepted chord re-solves."""
    x: torch.Tensor
    success: torch.Tensor
    residual: torch.Tensor
    iterations: torch.Tensor
    attempts: torch.Tensor
    rate_ok: torch.Tensor | None = None
    pos_ok: torch.Tensor | None = None
    sums_ok: torch.Tensor | None = None
    dt_exit: torch.Tensor | None = None
    chords: torch.Tensor | None = None


class SolverOptions(NamedTuple):
    rate_tol: float = 1.0e-8      # absolute residual tolerance on max |dy/dt|
    rate_tol_rel: float = 1.0e-9  # tolerance relative to the gross-flux scale
    coverage_tol: float = 5.0e-2  # allowed deviation of group sums from 1
    neg_tol: float = 5.0e-3       # allowed negative-coverage excursion
    dt0: float = 1.0e-9           # initial pseudo-time step
    dt_max: float = 1.0e20
    dt_grow_min: float = 2.0      # guaranteed SER growth per accepted step
    max_steps: int = 200          # PTC iterations per attempt
    max_attempts: int = 5
    floor: float = 1.0e-32        # coverage floor
    chord_steps: int = 0          # frozen-factorization re-solves per step


def _full(ref, value):
    return torch.full_like(ref, value)


def _per_tenant(fn, groups_dyn, *lanes):
    """``fn(*lanes, groups_dyn)``; for stacked groups ``[K, n_g, n]`` (a
    packed batch, lanes tenant-major) ``fn`` on each tenant's lanes with
    its groups, the results concatenated along the lanes. Each tenant's
    operands are fresh copies in the solo batch's layout (the caller
    stacks the groups in their own layout: ``parallel.batch.
    _stack_tenants``), so each tenant's group sums (``x @
    groups_dyn.T``) take the same cuBLAS kernel, hence the same float32
    rounding, as its solo batch's."""
    if groups_dyn.dim() == 2:
        return fn(*lanes, groups_dyn)
    K = groups_dyn.shape[0]
    chunks = [a.chunk(K) for a in lanes]
    outs = [fn(*(c[k].clone() for c in chunks), groups_dyn[k].clone())
            for k in range(K)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def _normalize(x, groups_dyn, floor):
    """Renormalize each conservation group of ``x [L, n]`` to sum 1,
    flooring at ``floor``; entries outside every group are untouched."""
    if groups_dyn.dim() == 3:
        return _per_tenant(lambda xk, g: _normalize(xk, g, floor),
                           groups_dyn, x)
    x = torch.where(x < floor, _full(x, floor), x)
    sums = x @ groups_dyn.T                                  # [L, n_g]
    scale = torch.where(sums > 0, 1.0 / sums, torch.ones_like(sums)) \
        @ groups_dyn                                         # [L, n]
    in_group = groups_dyn.sum(dim=0) > 0
    return torch.where(in_group, x * scale, x)


def _tol_scale(gross, opts: SolverOptions):
    """``rate_tol + rate_tol_rel * gross`` rounded once (``addcmul``), as
    XLA's CPU backend fuses the JAX package's expression into one
    multiply-add."""
    return torch.addcmul(_full(gross, opts.rate_tol), gross,
                         _full(gross, opts.rate_tol_rel))


def _rnorm(F, gross, opts: SolverOptions):
    """Normalized residual per lane: ``max_i |F_i| / (atol + rtol *
    gross_i)``; converged when <= 1."""
    return torch.amax(torch.abs(F) / _tol_scale(gross, opts), dim=-1)


def conservation_constraints(groups_dyn):
    """Row-replacement operators ``(R [n, n], M [n])`` for the
    conservation constraints: the first member row of each nonempty
    group is replaced by the group row and its residual entry zeroed, so
    Newton walks along the conservation manifold through a nonsingular
    matrix. Apply as ``where(M[:, None] > 0, R, A)`` and ``F * (1 - M)``
    (:func:`_constrained`, :func:`_keep`). (Static per spec, so computed
    on the host.) Stacked groups ``[K, n_g, n]`` give ``R [K, n, n]``
    and ``M [K, n]``."""
    if groups_dyn.dim() == 3:
        pairs = [conservation_constraints(g) for g in groups_dyn]
        return (torch.stack([p[0] for p in pairs]),
                torch.stack([p[1] for p in pairs]))
    G = groups_dyn.detach().cpu().numpy()
    n = G.shape[1]
    have = np.sum(G > 0, axis=1) > 0
    con_rows = np.argmax(G > 0, axis=1)
    R = np.zeros((n, n))
    np.add.at(R, con_rows, np.where(have[:, None], G, 0.0))
    M = np.zeros(n)
    np.maximum.at(M, con_rows, have.astype(float))
    t = lambda a: torch.as_tensor(a, dtype=groups_dyn.dtype,
                                  device=groups_dyn.device)
    return t(R), t(M)


def _constrained(A, R, M):
    """``where(M[:, None] > 0, R, A)`` on every lane of ``A [L, n, n]``;
    per-tenant ``R [K, n, n]``, ``M [K, n]`` act on each tenant's block
    of the tenant-major lanes."""
    if R.dim() == 2:
        return torch.where(M[:, None] > 0, R, A)
    K = R.shape[0]
    return torch.where(M[:, None, :, None] > 0, R[:, None],
                       A.view(K, -1, *A.shape[1:])).view(A.shape)


def _keep(F, M):
    """``F * (1 - M)`` on every lane of ``F [L, n]`` (per tenant for
    ``M [K, n]``)."""
    if M.dim() == 1:
        return F * (1.0 - M)
    K = M.shape[0]
    return (F.view(K, -1, F.shape[-1]) * (1.0 - M)[:, None]).view(F.shape)


def _direction_factor(A):
    """Factor the batched PTC matrices ``A [L, n, n]`` once and return the
    solve closure (chord steps reuse it) -- the one direction-solve site,
    routed by :func:`linalg.select_solver` as the JAX package's
    ``_direction_factor`` routes it: on the bucket sizes and above n =
    48 the ``lu_factor`` + ``lu_solve`` kernels (their plain versions on
    the CPU), off the buckets at n <= 48 one Gauss-Jordan solve of ``A``
    per right-hand side (not the explicit inverse of
    :func:`linalg.make_msolve`, whose matvecs round differently). The
    JAX package's ``opts`` argument only chooses between two forms of
    its LU route, ``lu_solve(*lu_factor(A), b)`` per solve or one
    factorization reused, which give the same bits; the port always
    factors once."""
    choice = linalg.select_solver(A.shape[-1])
    if choice.path == "gauss":
        return lambda b: choice.solve(A, b)
    return choice.make_solve(A)


def _direction_solve(A, b):
    """One-shot direction solve through :func:`_direction_factor`."""
    return _direction_factor(A)(b)


def _ptc_attempt(fscale_fn, jac_fn, x0, groups_dyn, opts: SolverOptions):
    """One PTC run of every lane from ``x0 [L, n]``; returns ``(x,
    normalized_residual, steps, dt_at_exit, chords_accepted)``, each with
    a leading lane dimension."""
    L, n = x0.shape
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
    R, M = conservation_constraints(groups_dyn)
    zero = torch.zeros((), dtype=x0.dtype, device=x0.device)

    F, gross = fscale_fn(x0)
    fnorm = _rnorm(F, gross, opts)
    x = x0
    dt = torch.full((L,), float(opts.dt0), dtype=x0.dtype, device=x0.device)
    k = torch.zeros(L, dtype=torch.int64, device=x0.device)
    nch = torch.zeros(L, dtype=torch.int32, device=x0.device)
    while True:
        active = (k < opts.max_steps) & (fnorm > 1.0)
        SYNCS["ptc_active"] += 1
        if not bool(active.any()):
            break
        J = jac_fn(x)
        A = _constrained(eye / dt[:, None, None] - J, R, M)
        solve_fn = _direction_factor(A.contiguous())
        dx = solve_fn(_keep(F, M).contiguous())
        # Projected PTC: clamp nonnegative and renormalize the
        # conservation groups.
        x_new = _normalize(torch.maximum(x + dx, zero), groups_dyn,
                           opts.floor)
        F_new, gross_new = fscale_fn(x_new)
        fnorm_new = _rnorm(F_new, gross_new, opts)
        nch_step = torch.zeros_like(nch)
        for _ in range(opts.chord_steps):
            dxc = solve_fn(_keep(F_new, M).contiguous())
            x_c = _normalize(torch.maximum(x_new + dxc, zero), groups_dyn,
                             opts.floor)
            F_c, gross_c = fscale_fn(x_c)
            f_c = _rnorm(F_c, gross_new, opts)
            take = (torch.isfinite(f_c)
                    & torch.all(torch.isfinite(x_c), dim=-1)
                    & (f_c < fnorm_new))
            nch_step = nch_step + take.to(torch.int32)
            x_new = torch.where(take[:, None], x_c, x_new)
            F_new = torch.where(take[:, None], F_c, F_new)
            gross_new = torch.where(take[:, None], gross_c, gross_new)
            fnorm_new = torch.where(take, f_c, fnorm_new)
        if opts.chord_steps > 0:
            fnorm_new = _rnorm(F_new, gross_new, opts)
        finite = torch.isfinite(fnorm_new) & torch.all(
            torch.isfinite(x_new), dim=-1)
        accept = finite & (fnorm_new <= 10.0 * fnorm)
        grow = torch.maximum(
            _full(fnorm, opts.dt_grow_min),
            fnorm / torch.maximum(fnorm_new, _full(fnorm_new, 1e-300)))
        dt_new = torch.where(
            accept,
            torch.clamp(dt * torch.minimum(grow, _full(grow, 1.0e6)),
                        min=1e-14, max=opts.dt_max),
            dt * 0.25)
        x_next = torch.where(accept[:, None], x_new, x)
        F_next = torch.where(accept[:, None], F_new, F)
        fnorm_next = torch.where(accept, fnorm_new, fnorm)
        # The while_loop batching rule: finished lanes keep their state.
        x = torch.where(active[:, None], x_next, x)
        F = torch.where(active[:, None], F_next, F)
        dt = torch.where(active, dt_new, dt)
        fnorm = torch.where(active, fnorm_next, fnorm)
        nch = torch.where(active, nch + nch_step, nch)
        k = torch.where(active, k + 1, k)
    return x, fnorm, k, dt, nch


def _verdict_tests(x, fnorm, groups_dyn, opts: SolverOptions):
    """The three convergence tests per lane: normalized residual <= 1,
    no coverage below ``-neg_tol``, every nonempty group sums to 1
    within ``coverage_tol``."""
    if groups_dyn.dim() == 3:
        return _per_tenant(lambda xk, fk, g: _verdict_tests(xk, fk, g, opts),
                           groups_dyn, x, fnorm)
    rate_ok = fnorm <= 1.0
    pos_ok = torch.all(x >= -opts.neg_tol, dim=-1)
    sums = x @ groups_dyn.T
    have_group = groups_dyn.sum(dim=1) > 0
    sums_ok = torch.all(
        torch.where(have_group, torch.abs(sums - 1.0) <= opts.coverage_tol,
                    torch.ones_like(have_group)), dim=-1)
    return rate_ok, pos_ok, sums_ok


def _verdict(x, fnorm, groups_dyn, opts: SolverOptions):
    rate_ok, pos_ok, sums_ok = _verdict_tests(x, fnorm, groups_dyn, opts)
    return rate_ok & pos_ok & sums_ok


def _score(x, fnorm, groups_dyn, opts: SolverOptions):
    """Lexicographic solution score: tests passed first, residual second
    (``passed * 1e6 - min(fnorm, 5e5)``; higher is better)."""
    rate_ok, pos_ok, sums_ok = _verdict_tests(x, fnorm, groups_dyn, opts)
    passed = (rate_ok.to(x.dtype) + pos_ok.to(x.dtype)
              + sums_ok.to(x.dtype))
    big = 1.0e6
    return passed * big - torch.minimum(fnorm, _full(fnorm, 0.5 * big))


def _lm_attempt(fscale_fn, jac_fn, x0, groups_dyn, opts: SolverOptions):
    """One projected Levenberg-Marquardt run of every lane from ``x0 [L,
    n]``: it descends ``||F / scale||^2`` with ``scale = rate_tol +
    rate_tol_rel * gross`` frozen at each iterate, the damping ``lam *
    max(diag JtJ)`` starting at ``lam = 1e-10``, the conservation rows
    replaced as in the PTC step and the same projection. A step is kept
    on a strict residual decrease (``lam / 3``, floor 1e-12), else
    ``lam * 10`` (cap 1e12). Returns ``(x, normalized_residual, steps,
    lam_at_exit, chords)`` with chords 0, the layout of
    :func:`_ptc_attempt`."""
    L, n = x0.shape
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device)
    R, M = conservation_constraints(groups_dyn)
    zero = torch.zeros((), dtype=x0.dtype, device=x0.device)

    F, gross = fscale_fn(x0)
    fnorm = _rnorm(F, gross, opts)
    x = x0
    lam = torch.full((L,), 1.0e-10, dtype=x0.dtype, device=x0.device)
    k = torch.zeros(L, dtype=torch.int64, device=x0.device)
    while True:
        active = (k < opts.max_steps) & (fnorm > 1.0)
        SYNCS["lm_active"] += 1
        if not bool(active.any()):
            break
        scale = _tol_scale(gross, opts)
        J = jac_fn(x) / scale[:, :, None]
        Jt = J.transpose(-2, -1)
        JtJ = Jt @ J
        dmax = torch.clamp(torch.amax(torch.diagonal(JtJ, dim1=-2, dim2=-1),
                                      dim=-1), min=1e-300)
        A = _constrained(JtJ + (lam * dmax)[:, None, None] * eye, R, M)
        g = torch.where(M > 0, zero, (Jt @ (F / scale)[:, :, None])[..., 0])
        dx = _direction_solve(A.contiguous(), _keep(-g, M).contiguous())
        x_new = _normalize(torch.maximum(x + dx, zero), groups_dyn,
                           opts.floor)
        F_new, gross_new = fscale_fn(x_new)
        fnorm_new = _rnorm(F_new, gross_new, opts)
        finite = torch.isfinite(fnorm_new) & torch.all(
            torch.isfinite(x_new), dim=-1)
        take = active & finite & (fnorm_new < fnorm)
        # lam / 3 as XLA compiles the JAX package's: times the rounded
        # reciprocal of 3.
        lam_new = torch.where(take, torch.clamp(lam * (1.0 / 3.0),
                                                min=1e-12),
                              torch.clamp(lam * 10.0, max=1e12))
        x = torch.where(take[:, None], x_new, x)
        F = torch.where(take[:, None], F_new, F)
        gross = torch.where(take[:, None], gross_new, gross)
        fnorm = torch.where(take, fnorm_new, fnorm)
        lam = torch.where(active, lam_new, lam)
        k = torch.where(active, k + 1, k)
    return x, fnorm, k, lam, torch.zeros(L, dtype=torch.int32,
                                         device=x0.device)


def bulk_options(opts: SolverOptions, tier: str) -> SolverOptions:
    """The tolerances the bulk march of ``tier`` can reach: an f32
    residual carries ~eps32 * gross of rounding noise, above the float64
    test's ``rate_tol_rel * gross``, so the bulk runs against tolerances
    floored at its noise level (``rate_tol`` at least 1e-5,
    ``rate_tol_rel`` at least 32 eps of the bulk dtype) and the float64
    polish does the rest. Only the bulk march uses them; the verdict
    takes the caller's ``opts``."""
    eps_b = float(torch.finfo(precision.bulk_dtype(tier)).eps)
    return opts._replace(
        rate_tol=max(float(opts.rate_tol), 1.0e-5),
        rate_tol_rel=max(float(opts.rate_tol_rel), 32.0 * eps_b))


#: Float64 Newton polish steps after a reduced-precision bulk march:
#: each squares the bulk's ~1e-7-relative error, so two land far below
#: every float64 tolerance; a step is kept only where it does not raise
#: the residual.
POLISH_STEPS = 2


def _polish_newton(fscale_fn, jac_fn, x, groups_dyn, opts: SolverOptions,
                   steps: int):
    """``steps`` conservation-constrained Newton steps from ``x [L, n]``
    at the closures' precision (float64), each kept on a lane only where
    its state and residual are finite and its normalized residual (at the
    caller's ``opts``) does not grow; the same projection as the PTC
    step. Returns ``(x, normalized_residual)``."""
    R, M = conservation_constraints(groups_dyn)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    F, gross = fscale_fn(x)
    fnorm = _rnorm(F, gross, opts)
    for _ in range(steps):
        B = _constrained(jac_fn(x), R, M)
        dx = _direction_solve(B.contiguous(), _keep(F, M).contiguous())
        x_new = _normalize(torch.maximum(x - dx, zero), groups_dyn,
                           opts.floor)
        F_new, gross_new = fscale_fn(x_new)
        fnorm_new = _rnorm(F_new, gross_new, opts)
        keep = (torch.isfinite(fnorm_new)
                & torch.all(torch.isfinite(x_new), dim=-1)
                & (fnorm_new <= fnorm))
        x = torch.where(keep[:, None], x_new, x)
        F = torch.where(keep[:, None], F_new, F)
        fnorm = torch.where(keep, fnorm_new, fnorm)
    return x, fnorm


def solve_steady(fscale_fn: Callable, jac_fn: Callable, x0, groups_dyn,
                 opts: SolverOptions, key=None, strategy: str = "ptc",
                 lanes: Callable | None = None, tier: str = "f64",
                 bulk_fns: tuple | None = None):
    """Steady solve of ``F(x) = 0`` for every lane.

    ``fscale_fn(x) -> (F, gross)`` and ``jac_fn(x) -> J`` act on the lane
    batch ``x [L, n]``; ``groups_dyn [n_g, n]`` are the conservation
    groups over the dynamic indices. ``strategy`` is ``"ptc"`` or
    ``"lm"`` (:func:`_lm_attempt`).

    With ``opts.max_attempts == 1`` one attempt runs from ``x0`` and is
    kept over ``x0`` when it passes the verdict or scores better: the
    sweep's fast pass and the polish rung. (The JAX package's rescue
    program takes its general loop at one attempt too, its
    ``max_attempts`` being traced; at one attempt the two give the same
    bits.) Otherwise the general loop runs up to ``max_attempts``
    attempts per lane, stopping a lane at its first success. ``key [L,
    2]`` holds each lane's PRNG key (:mod:`..ops.prng`; None:
    ``prng_key(0)`` for every lane) and is split at every attempt;
    attempt 0 starts from ``x0``, attempt 1 from the renormalized
    ``|x|`` of attempt 0's output, later attempts from a renormalized
    uniform draw. The best-scoring iterate (from ``score(x0)``, replaced
    on a strict gain) is returned where no attempt succeeded; a success
    re-evaluates its residual. The loop needs ``lanes(idx) ->
    (fscale_fn, jac_fn)`` restricted to the lanes ``idx`` (a long
    tensor): each attempt after a success runs only the lanes still
    failing, and a finished lane keeps its state.

    Returns ``(x, success, normalized_residual, iterations, attempts,
    rate_ok, pos_ok, sums_ok, dt_exit, chords)``; ``dt_exit`` is the last
    attempt's exit pseudo-step (PTC) or damping (LM).

    ``tier`` / ``bulk_fns``: under ``"f32-polish"``, with ``bulk_fns =
    (bulk_fscale_fn, bulk_jac_fn)`` the same closures over the same
    finished rate constants at the bulk dtype, a single-attempt solve
    marches in float32 against :func:`bulk_options`, then takes
    :data:`POLISH_STEPS` float64 Newton steps (:func:`_polish_newton`) and
    the verdict at ``opts``, with the same best-of-{x0, x1} scoreboard;
    iterations count the polish steps, ``dt_exit`` comes back in float64.
    A multi-attempt solve ignores the tier (the rescue ladder is float64).
    Stacked ``groups_dyn [K, n_g, n]`` (a packed batch, see the module
    doc) serve the single-attempt solve."""
    precision.check_tier(tier)
    attempt_fn = _lm_attempt if strategy == "lm" else _ptc_attempt
    F0, gross0 = fscale_fn(x0)
    f0 = _rnorm(F0, gross0, opts)
    if opts.max_attempts == 1:
        tiered = tier != "f64" and bulk_fns is not None
        if tiered:
            xb, _, k, dt_exit, chords = attempt_fn(
                *bulk_fns, precision.cast_bulk(x0, tier),
                precision.cast_bulk(groups_dyn, tier),
                bulk_options(opts, tier))
            x1, f1 = _polish_newton(fscale_fn, jac_fn,
                                    precision.cast_verify(xb), groups_dyn,
                                    opts, POLISH_STEPS)
            k = k + POLISH_STEPS
            dt_exit = precision.cast_verify(dt_exit)
        else:
            x1, f1, k, dt_exit, chords = attempt_fn(fscale_fn, jac_fn, x0,
                                                    groups_dyn, opts)
        ok = _verdict(x1, f1, groups_dyn, opts)
        better = _score(x1, f1, groups_dyn, opts) > _score(x0, f0,
                                                          groups_dyn, opts)
        take = ok | better
        x_out = torch.where(take[:, None], x1, x0)
        f_out = torch.where(take, f1, f0)
        rate_ok, pos_ok, sums_ok = _verdict_tests(x_out, f_out, groups_dyn,
                                                  opts)
        return (x_out, ok, f_out, k, torch.ones_like(k), rate_ok, pos_ok,
                sums_ok, dt_exit, chords)

    if lanes is None or groups_dyn.dim() != 2:
        raise ValueError("a multi-attempt solve needs one mechanism's "
                         "groups and lanes(idx) -> (fscale_fn, jac_fn) over "
                         "a subset of the lanes")
    L, n = x0.shape
    dev = x0.device
    key = prng.prng_key(0, dev).expand(L, 2) if key is None else \
        torch.as_tensor(key, dtype=torch.int64, device=dev).expand(L, 2)
    key = key.clone()
    x, best_x = x0.clone(), x0.clone()
    best_f = f0.clone()
    best_s = _score(x0, f0, groups_dyn, opts)
    success = torch.zeros(L, dtype=torch.bool, device=dev)
    iters = torch.zeros(L, dtype=torch.int64, device=dev)
    attempts = torch.zeros(L, dtype=torch.int64, device=dev)
    dt_exit = torch.full((L,), float(opts.dt0), dtype=x0.dtype, device=dev)
    chords = torch.zeros(L, dtype=torch.int32, device=dev)
    for attempt in range(opts.max_attempts):
        SYNCS["attempt_active"] += 1
        sel = torch.nonzero(~success).flatten()
        if sel.numel() == 0:
            break
        fs, jf = (fscale_fn, jac_fn) if sel.numel() == L else lanes(sel)
        pair = prng.split(key[sel])
        if attempt == 0:
            x_start = x[sel]
        elif attempt == 1:
            x_start = _normalize(torch.abs(x[sel]), groups_dyn, opts.floor)
        else:
            x_start = _normalize(prng.uniform(pair[:, 1], (n,)), groups_dyn,
                                 opts.floor)
        x_new, fnorm, k, dt_new, nch = attempt_fn(
            fs, jf, x_start.contiguous(), groups_dyn, opts)
        s_new = _score(x_new, fnorm, groups_dyn, opts)
        better = s_new > best_s[sel]
        best_x[sel[better]] = x_new[better]
        best_f[sel[better]] = fnorm[better]
        best_s[sel[better]] = s_new[better]
        x[sel] = x_new
        success[sel] = _verdict(x_new, fnorm, groups_dyn, opts)
        iters[sel] += k
        attempts[sel] += 1
        dt_exit[sel] = dt_new
        chords[sel] += nch
        key[sel] = pair[:, 0]
    Fx, grossx = fscale_fn(x)
    f_out = torch.where(success, _rnorm(Fx, grossx, opts), best_f)
    x_out = torch.where(success[:, None], x, best_x)
    rate_ok, pos_ok, sums_ok = _verdict_tests(x_out, f_out, groups_dyn, opts)
    return (x_out, success, f_out, iters, attempts, rate_ok, pos_ok,
            sums_ok, dt_exit, chords)


def lane_finite_mask(x, residual):
    """Per-lane finiteness of the stored state AND the residual."""
    return torch.all(torch.isfinite(x), dim=-1) & torch.isfinite(residual)


def packed_sweep_diagnostics(success, quarantined, ambiguous=None,
                             demoted=None, n_negative_tof=None):
    """Every cross-lane verdict count in ONE int32 vector:
    ``[n_failed, n_quarantined, n_ambiguous, n_demoted, n_negative_tof]``
    (absent entries report -1), so a sweep materializes one bundle."""
    dev = success.device

    def _count(v):
        if v is None:
            return torch.tensor(-1, dtype=torch.int32, device=dev)
        if torch.is_tensor(v) and v.dim() > 0:
            return torch.sum(v).to(torch.int32)
        return torch.as_tensor(v, device=dev).to(torch.int32)

    return torch.stack([
        torch.sum(~success).to(torch.int32),
        torch.sum(quarantined).to(torch.int32),
        _count(ambiguous), _count(demoted), _count(n_negative_tof)])


#: Rescue-strategy codes of the lane telemetry's ``strategy`` column: 0
#: solved by the fast pass, then the rescue ladder's rungs in order and
#: the two terminal demotions.
STRATEGY_CODES = {
    "clean": 0,
    "polish": 1,
    "ptc": 2,
    "lm": 3,
    "unseeded": 4,
    "demote": 5,
    "quarantine": 6,
}
STRATEGY_NAMES = {v: k for k, v in STRATEGY_CODES.items()}

#: Column order of the packed per-lane telemetry.
LANE_TELEMETRY_FIELDS = ("iterations", "chords", "residual_decade",
                         "strategy", "tier")


def residual_decade(residual):
    """``floor(log10(residual))`` clipped to [-99, 99] as int32; 99 for a
    non-finite residual, -99 for an exact zero."""
    r = residual
    pos = torch.where(r > 0, r, torch.ones_like(r))
    dec = torch.floor(torch.log10(pos))
    dec = torch.where(r > 0, dec, _full(dec, -99.0))
    dec = torch.where(torch.isfinite(r), dec, _full(dec, 99.0))
    return torch.clamp(dec, -99, 99).to(torch.int32)


def packed_lane_telemetry(iterations, chords, residual, strategy=0, tier=0):
    """Per-lane telemetry as one ``[L, 5]`` int32 tensor (columns:
    :data:`LANE_TELEMETRY_FIELDS`)."""
    it = iterations
    n = it.shape[0]
    ch = torch.zeros(n, dtype=torch.int32, device=it.device) \
        if chords is None else chords
    strat = torch.broadcast_to(torch.as_tensor(strategy, dtype=torch.int32,
                                               device=it.device), (n,))
    tcol = torch.broadcast_to(torch.as_tensor(tier, dtype=torch.int32,
                                              device=it.device), (n,))
    return torch.stack([it.to(torch.int32), ch.to(torch.int32),
                        residual_decade(residual), strat, tcol], dim=-1)


def deflation_basis(groups_dyn) -> np.ndarray:
    """Orthonormal basis Q [n_dyn, m] of the complement of the
    conservation rows -- the deflated subspace of the Lyapunov
    certificate (host-side numpy, static per spec)."""
    G = np.asarray(groups_dyn, dtype=float)
    G = G[(G > 0).any(axis=1)] if G.size else G.reshape(0, G.shape[-1])
    n = np.asarray(groups_dyn).shape[-1]
    if G.shape[0] == 0:
        return np.eye(n)
    _, s, Vt = np.linalg.svd(G)
    rank = int((s > 1e-12 * max(s[0], 1.0)).sum())
    return np.ascontiguousarray(Vt[rank:].T)


def deflation_basis_for_spec(spec) -> np.ndarray:
    """:func:`deflation_basis` of a host ModelSpec's dynamic block."""
    groups_dyn = np.asarray(spec.groups)[:, np.asarray(
        spec.dynamic_indices)]
    return deflation_basis(groups_dyn)


#: Deflated dimension above which the Lyapunov certificate is skipped
#: (its Kronecker system is m^2 x m^2 per lane).
LYAPUNOV_MAX_DIM = 8


def effective_unit_roundoff(dtype=torch.float64) -> float:
    """Unit roundoff of ``dtype`` arithmetic: the plain finfo epsilon (the
    CPU and the CUDA card both have native IEEE float64)."""
    return float(torch.finfo(dtype).eps)


def lyapunov_certified_stable(J, Q, tol, eps_eff: float | None = None):
    """Sound one-way stability certificate per lane via a deflated
    Lyapunov solve: certifies ``max Re eig(J) <= tol`` by building a
    Lyapunov witness for ``A = (Q^T J Q - tol I)/scale``:

        solve  (I (x) A^T + A^T (x) I) vec(P) = -vec(I)
        S = sym(P),  R = A^T S + S A + I

    and checking on the computed matrices that S is positive definite
    (elimination pivots with a rounding margin) and ||R||_2 < 1 with a
    per-entry forward-error margin. A bad solve can only abstain.

    ``J [L, n, n]``, ``Q [n, m]`` (m >= 1; a numpy array or a
    tensor), ``tol [L]``; the ``m^2 x m^2`` Kronecker system is solved
    through :func:`linalg.solve` (``factor_solve`` at m = 4, the padded
    ABI basis, and at m >= 7; Gauss-Jordan below). Returns a bool
    tensor ``[L]``."""
    L = J.shape[0]
    m = Q.shape[1]
    dev, dt = J.device, J.dtype
    Qc = torch.as_tensor(Q, dtype=dt, device=dev)
    B = Qc.T @ J @ Qc
    eye = torch.eye(m, dtype=dt, device=dev)
    sc = torch.clamp(torch.amax(torch.abs(B), dim=(-2, -1)), min=1e-300)
    A = (B - tol[:, None, None] * eye) / sc[:, None, None]
    AT = A.transpose(-2, -1)
    K = (torch.einsum("ij,lab->liajb", eye, AT)
         + torch.einsum("lab,ij->laibj", AT, eye)).reshape(L, m * m, m * m)
    rhs = (-eye.reshape(-1)).expand(L, m * m).contiguous()
    p = linalg.solve(K.contiguous(), rhs)
    P = p.reshape(L, m, m)
    S = 0.5 * (P + P.transpose(-2, -1))
    R = AT @ S + S @ A + eye
    R = 0.5 * (R + R.transpose(-2, -1))
    pmax = torch.amax(torch.abs(S), dim=(-2, -1))
    eps = effective_unit_roundoff(dt) if eps_eff is None else float(eps_eff)
    absA, absS = torch.abs(A), torch.abs(S)
    E = 4.0 * (m + 2) * eps * (absA.transpose(-2, -1) @ absS
                               + absS @ absA + eye)
    E = 0.5 * (E + E.transpose(-2, -1))
    bound_R = torch.amax(torch.sum(torch.abs(R) + E, dim=-1), dim=-1)
    ok = torch.all(torch.isfinite(S).reshape(L, -1), dim=-1) \
        & (bound_R < 0.5)
    pd_margin = 64.0 * eps * m * pmax
    Mx = S
    below = (torch.arange(m, device=dev)[:, None]
             > torch.arange(m, device=dev)[None, :])  # [i, k]: i > k
    zero = torch.zeros((), dtype=dt, device=dev)
    for k in range(m):
        piv = Mx[:, k, k]
        good = piv > pd_margin
        ok = ok & good
        denom = torch.where(good, piv, torch.ones_like(piv))
        outer = Mx[:, :, k, None] * (Mx[:, k, None, :] / denom[:, None, None])
        Mx = Mx - torch.where(below[:, k, None], outer, zero)
    return ok


def stability_tolerance_from_scale(scale, pos_tol: float = 1e-2,
                                   eps: float | None = None):
    """Scale-aware stability threshold ``pos_tol + 64 eps max|J|``."""
    if eps is None:
        eps = float(torch.finfo(scale.dtype).eps)
    return pos_tol + 64.0 * eps * scale


def stability_tolerance(jac: np.ndarray, pos_tol: float = 1e-2):
    """:func:`stability_tolerance_from_scale` of host Jacobians ``[...,
    n, n]`` (numpy), with their dtype's epsilon; returns ``[...]``."""
    jac = np.asarray(jac)
    scale = np.abs(jac).max(axis=(-2, -1))
    return stability_tolerance_from_scale(scale, pos_tol,
                                          float(np.finfo(jac.dtype).eps))


def jacobian_eigenvalues_stable(jac: np.ndarray, pos_tol: float = 1e-2):
    """Host stability verdict per Jacobian of ``jac [..., n, n]`` (numpy):
    every eigenvalue's real part at most :func:`stability_tolerance`.
    Returns a numpy bool array ``[...]``."""
    eig = np.linalg.eigvals(np.asarray(jac))
    return np.all(eig.real <= stability_tolerance(jac, pos_tol)[..., None],
                  axis=-1)
