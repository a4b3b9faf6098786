"""Stiff ODE integration over a lane batch: two adaptive L-stable ESDIRK
families (PyTorch port of ``pycatkin_tpu/solvers/ode.py``).

1. ``trbdf2`` -- TR-BDF2 (ESDIRK2(3), Hosea & Shampine), the default:

     stage 1 (TR):   g = y + (gamma*h/2) * (f(y) + f(g))
     stage 2 (BDF2): y1 = (g - (1-gamma)^2 y) / (gamma*(2-gamma))
                          + h*(1-gamma)/(2-gamma) * f(y1)

   with gamma = 2 - sqrt(2); both stages share the implicit coefficient
   d = gamma/2, so one factorization of (I - d*h*J) serves both stage
   solves and the error filter.
2. ``esdirk4`` -- ESDIRK4(3)6L[2]SA (Kennedy & Carpenter, NASA
   TM-2001-211038): six stages (the first explicit), stiffly accurate,
   L-stable, 4th order with an embedded 3rd-order error estimate; all
   five implicit stages share d = 1/4 and one factorization.

The embedded error estimate, filtered through (I - d*h*J)^-1, drives the
step controller. The stage matrices go through
:func:`..ops.linalg.make_msolve`, routed by their size n_s as the JAX
package routes them: the ``lu_factor`` + ``lu_solve`` kernels on the
bucket sizes and above n = 48, the explicit Gauss-Jordan inverse below.

The JAX package runs one ``lax.while_loop`` per lane under ``vmap``
inside a ``lax.scan`` over the save times. Here the save times are a
host loop, and inside each interval every lane still active (``t < t1``,
fewer than ``max_steps`` steps, no step collapse) takes a step together
with the others; a lane that stops keeps its carry ``(y, t, h, k, ok)``,
which is that batching rule. The batch is compacted to the active lanes
whenever one stops, so the step closures come from ``lanes(idx)``, which
restricts them to the lanes ``idx``. No arithmetic crosses lanes.
Deciding which lanes are still active is one device-to-host sync per
step, counted in :data:`SYNCS`; the steps taken are counted in
:data:`STEPS`.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..ops import linalg

GAMMA = 2.0 - math.sqrt(2.0)
D = GAMMA / 2.0
# 2nd-order solution weights (derived from the two-stage form).
B1 = 1.0 / (2.0 * (2.0 - GAMMA))
B2 = 1.0 / (2.0 * (2.0 - GAMMA))
B3 = (1.0 - GAMMA) / (2.0 - GAMMA)
# Embedded 3rd-order quadrature weights at c = [0, gamma, 1].
BH2 = 1.0 / (6.0 * GAMMA * (1.0 - GAMMA))
BH3 = 0.5 - GAMMA * BH2
BH1 = 1.0 - BH2 - BH3

# ESDIRK4(3)6L[2]SA tableau (Kennedy & Carpenter 2001, appendix C;
# exact rationals). First stage explicit; a_ii = 1/4 for i >= 2;
# stiffly accurate (b == last row of A), so y1 = z6.
E4_D = 0.25
E4_A = (
    (),                                                    # stage 1
    (0.25,),                                               # stage 2
    (8611.0 / 62500.0, -1743.0 / 31250.0),                 # stage 3
    (5012029.0 / 34652500.0, -654441.0 / 2922500.0,
     174375.0 / 388108.0),                                 # stage 4
    (15267082809.0 / 155376265600.0, -71443401.0 / 120774400.0,
     730878875.0 / 902184768.0, 2285395.0 / 8070912.0),    # stage 5
    (82889.0 / 524892.0, 0.0, 15625.0 / 83664.0,
     69875.0 / 102672.0, -2260.0 / 8211.0),                # stage 6
)
E4_B = E4_A[5] + (E4_D,)
E4_BHAT = (4586570599.0 / 29645900160.0, 0.0,
           178811875.0 / 945068544.0, 814220225.0 / 1159782912.0,
           -3700637.0 / 11593932.0, 61727.0 / 225920.0)

_NEWTON_ITERS = 6

#: Device-to-host syncs since the last :func:`reset_counters`: one per
#: step of :func:`_advance_to` (plus each interval's exit check), one
#: per Newton finish that picks its lanes (``engine.transient_finish``)
#: and one per diagnostics bundle a caller of
#: ``parallel.batch.batch_transient`` asks for.
SYNCS = {"ode_active": 0, "finish_lanes": 0, "transient_bundle": 0}

#: Lane-steps since the last :func:`reset_counters`: ``lanes`` counts
#: every step attempt of every active lane (a host int); ``tally`` is a
#: ``[2]`` int64 tensor on the latest integration's device (None before
#: the first step; moved along when an integration on another device
#: follows) of the accepted steps that moved a lane's time and of the
#: steps that ended an interval by the steadiness shortcut, the rest
#: being rejected. Three device ops a step update it and the loop never
#: reads it; :func:`step_counts` does.
STEPS: dict = {"lanes": 0, "tally": None}

#: Lanes handed to the Newton finish (``engine.transient_finish``) and
#: lanes it rescued (a 0-d tensor on the latest finish's device once
#: set) since the last :func:`reset_counters`.
FINISH: dict = {"lanes": 0, "rescued": 0}


def reset_counters() -> None:
    for d in (SYNCS, FINISH):
        for k in d:
            d[k] = 0
    STEPS.update(lanes=0, tally=None)


def step_counts() -> dict:
    """Lane-steps since the last :func:`reset_counters`, ``accepted``,
    ``rejected`` and ``steady`` (see :data:`STEPS`), as ints: a sync."""
    tally = STEPS["tally"]
    accepted, steady = (0, 0) if tally is None else tally.tolist()
    return {"accepted": accepted, "steady": steady,
            "rejected": STEPS["lanes"] - accepted - steady}


class ODEOptions(NamedTuple):
    """Integrator options, with the JAX package's defaults (see its
    ``solvers/ode.py`` for the reasoning behind each)."""
    rtol: float = 1.0e-8
    atol: float = 1.0e-10
    h0: float = 1.0e-10         # initial step
    max_steps: int = 4000       # per save interval
    method: str = "trbdf2"      # or "esdirk4"
    safety: float = 0.9
    min_factor: float = 0.2
    max_factor: float = 8.0
    # Stage-Newton iterate clamps; a converged stage on either bound
    # rejects the step (phantom roots of the stage equations).
    clamp: float = 1.0e3
    clamp_lo: float = -1.0e-6
    # Max relative state motion per error-waived (relaxed) step.
    relax_dy: float = 0.1
    # Net-vs-gross relative tolerance of the relax oracle and the finish.
    steady_rel: float = 1.0e-9


class OdeFns(NamedTuple):
    """The closures of one lane batch: ``f(y) -> dy/dt`` and ``jac(y) ->
    [L, n, n]`` on ``y [L, n]``; ``oracles(y) -> (f(y), steady,
    relaxed)`` (or None: no shortcut), where ``steady`` declares a lane
    steady at the arithmetic floor (its interval ends at once) and
    ``relaxed`` waives its local-error test (the JAX package's
    ``steady_fn`` and ``relax_fn``, evaluated with ``f`` in one pass)."""
    f: Callable
    jac: Callable
    oracles: Optional[Callable] = None
    # Lane counts of the independent blocks of a packed batch (None: one
    # block); see _blockwise.
    blocks: Optional[tuple] = None


def _fma(a, b, c):
    """``a * b + c`` rounded once (``addcmul``): XLA's CPU backend
    contracts the JAX package's multiply-adds into fused ones."""
    return torch.addcmul(c, a, b)


def _rms(v):
    """Root mean square over the last axis, per lane."""
    return torch.sqrt(torch.mean(v * v, dim=-1))


def _err_scale(y, opts: ODEOptions):
    """``atol + rtol |y|``, the error-control scale."""
    return _fma(torch.abs(y), torch.full_like(y, opts.rtol),
                torch.full_like(y, opts.atol))


def _stage_solve(f, msolve, z0, rhs_const, h, scale, opts: ODEOptions,
                 d=D):
    """Solve ``z = rhs_const + d*h*f(z)`` for every lane by simplified
    Newton with the frozen factorized iteration matrix (I - d*h*J):
    exactly ``_NEWTON_ITERS`` iterations, each iterate clamped to
    ``[clamp_lo, clamp]``. Returns ``(z, converged)``: converged when the
    last correction's RMS relative to ``scale`` is below 0.1 and the
    solution sits on neither clamp bound (a solution pinned there is not
    one of the stage equations, and one converged against the lower
    bound is a phantom root)."""
    dh = (-(d * h))[:, None]
    z = z0
    for _ in range(_NEWTON_ITERS):
        res = _fma(dh, f(z), z - rhs_const)
        dz = msolve(res.contiguous())
        z = torch.clamp(z - dz, opts.clamp_lo, opts.clamp)
    # Only the last correction decides convergence.
    dz_norm = _rms(dz / scale)
    on_clamp = torch.any((z >= opts.clamp) | (z <= opts.clamp_lo), dim=-1)
    return z, (dz_norm < 0.1) & ~on_clamp


def _iteration_matrix(jac, y, h, d):
    """``I - d*h*J(y)`` per lane, contiguous."""
    n = y.shape[-1]
    eye = torch.eye(n, dtype=y.dtype, device=y.device)
    return _fma((-(d * h))[:, None, None], jac(y), eye).contiguous()


def _error_ratio(msolve, err_raw, y, y1, opts: ODEOptions):
    """RMS of the stiffly filtered error ``(I - d*h*J)^-1 err_raw``
    relative to ``atol + rtol max(|y|, |y1|)``."""
    err = msolve(err_raw.contiguous())
    scale = _err_scale(torch.maximum(torch.abs(y), torch.abs(y1)), opts)
    return _rms(err / scale)


def _trbdf2_step(f, jac, y, t, h, opts: ODEOptions, f0=None):
    """One TR-BDF2 step attempt of every lane (``y [L, n]``, ``h [L]``).
    Returns ``(y_new, err_ratio, ok)``; ``f0``: f(y) if already
    evaluated."""
    # One factorization serves both stages and the error filter.
    msolve = linalg.make_msolve(_iteration_matrix(jac, y, h, D))
    if f0 is None:
        f0 = f(y)
    hc = h[:, None]
    scale0 = _err_scale(y, opts)
    # TR stage to t + gamma*h
    g, conv1 = _stage_solve(f, msolve, _fma(GAMMA * hc, f0, y),
                            _fma(D * hc, f0, y), h, scale0, opts)
    fg = f(g)
    # BDF2 stage to t + h
    c_g = 1.0 / (GAMMA * (2.0 - GAMMA))
    c_y = (1.0 - GAMMA) ** 2 / (GAMMA * (2.0 - GAMMA))
    rhs_const = _fma(torch.full_like(g, c_g), g, -(c_y * y))
    y1, conv2 = _stage_solve(f, msolve, _fma(D * hc, fg, rhs_const),
                             rhs_const, h, scale0, opts)
    f1 = f(y1)

    # Embedded error, stiffly filtered.
    e = _fma(torch.full_like(fg, B2 - BH2), fg, (B1 - BH1) * f0)
    err_raw = hc * _fma(torch.full_like(f1, B3 - BH3), f1, e)
    err_ratio = _error_ratio(msolve, err_raw, y, y1, opts)
    ok = (torch.isfinite(err_ratio)
          & torch.all(torch.isfinite(y1), dim=-1) & conv1 & conv2)
    return y1, torch.where(ok, err_ratio, torch.full_like(err_ratio,
                                                          math.inf)), ok


def _esdirk4_step(f, jac, y, t, h, opts: ODEOptions, f0=None):
    """One ESDIRK4(3)6L[2]SA step attempt of every lane. Returns
    ``(y_new, err_ratio, ok)``; ``f0``: f(y) if already evaluated.

    All five implicit stages share d = 1/4, so one factorization serves
    the whole step; each stage starts from the previous stage's value,
    and its derivative comes from the stage equation, ``k_i = (z -
    acc) / (d*h)``. Stiffly accurate: y_new is the last stage."""
    msolve = linalg.make_msolve(_iteration_matrix(jac, y, h, E4_D))
    if f0 is None:
        f0 = f(y)
    hc = h[:, None]
    scale0 = _err_scale(y, opts)

    ks = [f0]
    conv = torch.ones_like(h, dtype=torch.bool)
    z = y
    for i in range(1, 6):
        acc = y
        for j, a in enumerate(E4_A[i]):
            if a != 0.0:
                acc = _fma(a * hc, ks[j], acc)
        z, ci = _stage_solve(f, msolve, z, acc, h, scale0, opts, d=E4_D)
        conv = conv & ci
        ks.append((z - acc) / (E4_D * hc))
    y1 = z

    e = (E4_B[0] - E4_BHAT[0]) * ks[0]
    for b, bh, k in zip(E4_B[1:], E4_BHAT[1:], ks[1:]):
        e = _fma(torch.full_like(k, b - bh), k, e)
    err_ratio = _error_ratio(msolve, hc * e, y, y1, opts)
    ok = (torch.isfinite(err_ratio)
          & torch.all(torch.isfinite(y1), dim=-1) & conv)
    return y1, torch.where(ok, err_ratio, torch.full_like(err_ratio,
                                                          math.inf)), ok


def _blockwise(fn, x, blocks):
    """``fn(x)`` for an elementwise ``fn``, evaluated on a fresh copy of
    each block of lanes (``blocks``: their counts; None: ``x`` whole).
    On the CPU, ATen runs a transcendental such as ``pow`` through SIMD
    code on whole vector chunks and scalar code on the tail, which round
    differently, so an element's result depends on its position in the
    batch; per block, a packed tenant's lanes get their solo run's. On
    the card every element goes through the same scalar code, so the
    batch is one call there."""
    if blocks is None or x.device.type != "cpu":
        return fn(x)
    return torch.cat([fn(b.clone()) for b in x.split(list(blocks))])


# Controller exponent: err ~ h^(q+1) with q the embedded order, so the
# optimal-step factor is err_ratio^(-1/(q+1)).
_STEP_FNS = {"trbdf2": (_trbdf2_step, 1.0 / 3.0),
             "esdirk4": (_esdirk4_step, 1.0 / 4.0)}


def _step(fns: OdeFns, y, t, h, k, ok, t1: float, opts: ODEOptions,
          step_fn, ctrl_exp: float):
    """The body of the JAX package's ``_advance_to`` loop for lanes that
    are all active: one step attempt each, the steadiness shortcut, the
    error test (waived on relaxed small moves) and the step controller.
    Returns the new carry ``(y, t, h, k, ok)``."""
    if fns.oracles is not None:
        f0, oracle, guard = fns.oracles(y)
    else:
        f0 = fns.f(y)
        oracle = guard = torch.zeros_like(ok)
    remaining = t1 - t
    # Integrate-to-steady shortcut: a constant-derivative extrapolation
    # over the whole remaining span stays within the error tolerance and
    # the relax oracle holds, or the hard oracle alone holds.
    span_ok = torch.all(torch.abs(f0) * remaining[:, None]
                        <= _err_scale(y, opts), dim=-1)
    steady = oracle | (span_ok & guard)
    h_try = torch.minimum(h, remaining)
    final = h >= remaining
    y_new, err_ratio, step_ok = step_fn(fns.f, fns.jac, y, t, h_try, opts,
                                        f0=f0)
    # The waiver covers noise-limited near-steady stepping only: a
    # relaxed step must barely move the state.
    small_move = torch.amax(torch.abs(y_new - y) / (1.0 + torch.abs(y)),
                            dim=-1) <= opts.relax_dy
    relaxed = guard & small_move
    accept = step_ok & ((err_ratio <= 1.0) | relaxed)
    factor = torch.where(err_ratio > 0,
                         _blockwise(lambda e: opts.safety * e ** (-ctrl_exp),
                                    err_ratio, fns.blocks),
                         opts.max_factor)
    # A non-finite factor reads as "shrink" (clamp propagates NaN).
    factor = torch.where(torch.isfinite(factor), factor, opts.min_factor)
    factor = torch.clamp(factor, opts.min_factor, opts.max_factor)
    factor = torch.where(relaxed & step_ok, opts.max_factor, factor)
    h_next = torch.clamp(h_try * factor, min=1e-300)
    moved = accept & ~steady
    y = torch.where(moved[:, None], y_new, y)
    # Land exactly on t1 when the step spans the remainder.
    t = torch.where(steady, t1,
                    torch.where(accept, torch.where(final, t1, t + h_try),
                                t))
    h_next = torch.where(steady, h, h_next)
    tally = torch.stack((moved, steady)).sum(dim=1)
    STEPS["lanes"] += len(moved)
    STEPS["tally"] = tally if STEPS["tally"] is None else \
        STEPS["tally"].to(tally.device) + tally
    # Failure only on persistent step collapse.
    return y, t, h_next, k + 1, ok & (h_next > 1e-250)


def _advance_to(lanes: Callable, y, t0, t1: float, h_init,
                opts: ODEOptions):
    """Adaptively integrate every lane from ``t0 [L]`` to ``t1``.
    Returns ``(y(t1), last_h, ok)``.

    ``lanes(idx) -> OdeFns`` gives the closures over the lanes ``idx``
    (an int64 numpy array on the host, ascending; None: all lanes). A
    lane steps while ``t < t1``, it has taken fewer than ``max_steps``
    steps in this interval and its step has not collapsed (``h <=
    1e-250``); the batch shrinks to the lanes still stepping whenever one
    stops."""
    if opts.method not in _STEP_FNS:
        raise ValueError(f"unknown ODE method {opts.method!r}: "
                         f"use one of {sorted(_STEP_FNS)}")
    step_fn, ctrl_exp = _STEP_FNS[opts.method]
    L = y.shape[0]
    dev = y.device
    t1 = float(t1)
    full = [y, t0, h_init, torch.zeros(L, dtype=torch.int64, device=dev),
            torch.ones(L, dtype=torch.bool, device=dev)]
    work, sel, sel_h, fns = full, None, None, lanes(None)
    while True:
        _, t, _, k, ok = work
        active = (t < t1) & (k < opts.max_steps) & ok
        SYNCS["ode_active"] += 1
        act = active.cpu().numpy()
        if not act.all():
            full = work if sel is None else [
                a.index_copy(0, sel, w) for a, w in zip(full, work)]
            if not act.any():
                break
            keep = np.flatnonzero(act)
            sel_h = keep if sel_h is None else sel_h[keep]
            sel = torch.as_tensor(sel_h, device=dev)
            work = [a[sel] for a in full]
            fns = lanes(sel_h)
        work = _step(fns, *work, t1, opts, step_fn, ctrl_exp)
    y, t, h, _, ok = full
    return y, h, ok & (t >= t1)


def init_state(y0, t0, opts: ODEOptions = ODEOptions()):
    """Integration carry ``(y, t, h, ok)`` of every lane of ``y0 [L,
    n]``, positioned at ``t0``."""
    L = y0.shape[0]
    full = lambda v: torch.full((L,), float(v), dtype=y0.dtype,
                                device=y0.device)
    return (y0, full(t0), full(opts.h0),
            torch.ones(L, dtype=torch.bool, device=y0.device))


def integrate_state(lanes: Callable, state, save_ts,
                    opts: ODEOptions = ODEOptions()):
    """Advance an integration carry through ``save_ts`` (all >= the
    carry's t), one :func:`_advance_to` interval each. Returns ``(state,
    ys [L, len(save_ts), n])``. Each interval starts from the carry's
    ``max(t, t_next)`` with a fresh step count, and ``h`` carries over;
    a repeated save time is a no-op."""
    y, t, h, ok = state
    ys = []
    for t_next in np.asarray(save_ts, dtype=np.float64).ravel():
        y, h, seg_ok = _advance_to(lanes, y, t, float(t_next), h, opts)
        ok = ok & seg_ok
        t = torch.clamp(t, min=float(t_next))
        ys.append(y)
    if not ys:
        return (y, t, h, ok), y.new_zeros((y.shape[0], 0, y.shape[1]))
    return (y, t, h, ok), torch.stack(ys, dim=1)


def integrate(lanes: Callable, y0, save_ts,
              opts: ODEOptions = ODEOptions()):
    """Integrate every lane of ``y' = f(y)`` from ``y0 [L, n]`` and
    return ``(ys [L, len(save_ts), n], ok [L])``; ``save_ts[0]`` is the
    initial time (``y0`` is reported there). ``lanes``: see
    :func:`_advance_to`."""
    save_ts = np.asarray(save_ts, dtype=np.float64).ravel()
    state = init_state(y0, save_ts[0], opts)
    (_, _, _, ok), ys = integrate_state(lanes, state, save_ts[1:], opts)
    return torch.cat([y0[:, None, :], ys], dim=1), ok


def log_time_grid(t0: float, t1: float, n: int = 200) -> np.ndarray:
    """Log-spaced output grid starting at 0: ``[0]`` then ``n`` points
    from ``t0`` (1e-8 when ``t0 <= 0``) to ``t1``."""
    start = t0 if t0 > 0 else 1.0e-8
    grid = np.logspace(np.log10(start), np.log10(t1), n)
    return np.concatenate([np.zeros(1), grid])
