"""The fused steady-state sweep over a lane batch and the public one-call
sweep (PyTorch port of ``_fused_sweep_program``, ``_abi_fused_body`` and
``sweep_steady_state`` of ``pycatkin_tpu/parallel/batch.py``).

:func:`fused_sweep` runs the whole clean sweep of one mechanism over a
batch of conditions: the single-attempt PTC solve of every lane, the
per-lane NaN quarantine, the tier-0 stability certificate (Gershgorin,
then the deflated Lyapunov certificate), TOF and activity, the packed
per-lane telemetry and the packed diagnostics bundle -- the same
outputs in the same order as the JAX program. Given an
:class:`~..frontend.abi.AbiLowered` it runs the padded mechanism, as the
JAX package's ABI body does.

:func:`sweep_steady_state` is the public entry: optionally lower into
the ABI bucket, run the fused sweep, then decide from the bundle as
the JAX package's ``_fused_decide`` does -- assemble a clean result, or
settle the ambiguous lanes by a host eigensolve. Lanes that would need
the rescue ladder (failed or quarantined lanes, or lanes the
eigensolve demotes) raise ``NotImplementedError`` (ROADMAP Queue A
item 7); no result is returned that differs from the JAX package's.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .. import engine
from ..frontend import abi as _abi
from ..frontend.spec import Conditions, ModelSpec
from ..solvers.newton import (LYAPUNOV_MAX_DIM, SolverOptions,
                              deflation_basis_for_spec,
                              effective_unit_roundoff, lane_finite_mask,
                              lyapunov_certified_stable,
                              packed_lane_telemetry,
                              packed_sweep_diagnostics,
                              stability_tolerance_from_scale)


def fast_pass_opts(opts: SolverOptions) -> SolverOptions:
    """The capped single-attempt first-pass options (at most 100 PTC
    iterations, one attempt)."""
    return opts._replace(max_steps=min(opts.max_steps, 100),
                         max_attempts=1)


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; raises when CUDA is missing rather
    than running on the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass "
                           "device='cpu' to run on the CPU")
    return dev


def broadcast_conditions(cond: Conditions, n: int) -> Conditions:
    """Repeat one condition ``n`` times along a new leading lane axis
    (numpy arrays; :func:`fused_sweep` moves them to the device)."""
    return Conditions(*(np.broadcast_to(np.asarray(v, dtype=np.float64),
                                        (n,) + np.shape(v)).copy()
                        for v in cond))


def stability_screen(ds: engine.DeviceSpec, conds: Conditions, ys,
                     pos_tol: float):
    """Tier-0 stability certificate of every lane at full states ``ys``:
    Gershgorin on the dynamic Jacobian, OR the deflated Lyapunov
    certificate. A lowered spec takes its padded basis ``lyap_q``
    (gated by ``lyap_ok``, so its Kronecker system is 16 x 16 on every
    lane); an unpadded one its own basis when its deflated dimension is
    1..8. Returns ``(cert, finite)`` bool tensors ``[L]``."""
    J = engine.steady_jacobian(ds, conds, ys[..., ds.dyn])
    absJ = torch.abs(J)
    diag = torch.diagonal(J, dim1=-2, dim2=-1)
    offrow = torch.sum(absJ, dim=-1) - torch.abs(diag)
    offcol = torch.sum(absJ, dim=-2) - torch.abs(diag)
    bound = torch.minimum(torch.amax(diag + offrow, dim=-1),
                          torch.amax(diag + offcol, dim=-1))
    scale = torch.amax(absJ, dim=(-2, -1))
    finite = torch.all(torch.isfinite(J).reshape(J.shape[0], -1), dim=-1)
    tol = stability_tolerance_from_scale(scale, pos_tol)
    cert = finite & (bound <= tol)
    eps = effective_unit_roundoff(J.dtype)
    if ds.lyap_q is not None:
        cert = cert | (finite & (ds.lyap_ok > 0) & lyapunov_certified_stable(
            J, ds.lyap_q, tol, eps_eff=eps))
    else:
        Q = deflation_basis_for_spec(ds.host)
        if 0 < Q.shape[1] <= LYAPUNOV_MAX_DIM:
            cert = cert | (finite & lyapunov_certified_stable(
                J, Q, tol, eps_eff=eps))
    return cert, finite


def _fused(ds: engine.DeviceSpec, conds: Conditions, tof_mask, x0,
           opts: SolverOptions, pos_tol: float, check_stability: bool):
    """:func:`fused_sweep` on an already bound spec and device
    conditions, from the initial guess ``x0`` (None: ``conds.y0``),
    with or without the stability screen (without it, ``cert`` and
    ``amb`` are absent and the bundle reports -1 for their counts)."""
    res = engine.steady_state(ds, conds, x0=x0, opts=opts)
    finite_l = lane_finite_mask(res.x, res.residual)
    succ_raw = res.success
    quar = succ_raw & ~finite_l
    succ0 = succ_raw & finite_l
    res = res._replace(success=succ0)
    outs = [res, quar]
    amb = demoted = None
    ok_spec = succ0
    if check_stability:
        cert_raw, finite = stability_screen(ds, conds, res.x, pos_tol)
        good = finite & succ0
        cert = good & cert_raw
        amb = good & ~cert
        demoted = succ0 & ~cert
        ok_spec = succ0 & cert
        outs += [cert, amb]
    n_neg = None
    if tof_mask is not None:
        mask = torch.as_tensor(np.asarray(tof_mask, dtype=np.float64),
                               dtype=torch.float64, device=ds.device)
        tofs = engine.tof(ds, conds, res.x, mask)
        act = engine.activity_from_tof(tofs, conds.T)
        neg = torch.isfinite(tofs) & (tofs < 0.0)
        lane_ok = ok_spec & torch.isfinite(tofs)
        n_neg = torch.sum(lane_ok & (tofs < 0.0))
        outs += [tofs, act, neg]
    outs.append(packed_lane_telemetry(res.iterations, res.chords,
                                      res.residual, tier=0))
    outs.append(packed_sweep_diagnostics(succ0, quar, amb, demoted, n_neg))
    return tuple(outs)


def _bind(spec, conds: Conditions, x0, device):
    dev = resolve_device(device)
    ds = engine.bind(spec, dev)
    conds = engine.conditions_to(conds, dev)
    if conds.T.dim() != 1:
        raise ValueError("conditions need a leading lane axis (see "
                         "broadcast_conditions)")
    if x0 is not None:
        x0 = torch.as_tensor(x0, dtype=torch.float64, device=dev)
    return ds, conds, x0


def fused_sweep(spec, conds: Conditions, tof_mask=None,
                opts: SolverOptions | None = None, pos_tol: float = 1e-2,
                device=None):
    """The clean sweep of ``spec`` over the lane batch ``conds`` (every
    field with a leading lane dimension).

    ``spec`` is a :class:`ModelSpec`, or an
    :class:`~..frontend.abi.AbiLowered` with ``conds`` and ``tof_mask``
    already padded to its bucket (``pad_conditions``,
    ``pad_tof_mask``); the outputs are then padded too. ``opts`` are the
    pass's solver options, by default
    ``fast_pass_opts(SolverOptions())``; ``max_attempts`` must be 1 (the
    fast pass draws no random numbers). ``tof_mask [n_r]`` selects the
    TOF steps (None: no TOF/activity). ``device=None`` runs on the CUDA
    card and raises without one; pass ``"cpu"`` for the CPU.

    Returns, in the JAX program's order (with ``check_stability``):
    ``res`` (:class:`SteadyStateResults`, success already
    quarantine-demoted), ``quar``, ``cert``, ``amb``; with a TOF mask:
    ``tofs``, ``act``, ``neg``; then the ``[L, 5]`` int32 lane telemetry
    and the int32 diagnostics bundle ``[n_failed, n_quarantined,
    n_ambiguous, n_demoted, n_negative_tof]``. Everything stays on the
    device; the only host syncs are the solver loop's any-lane-active
    checks (:data:`solvers.newton.SYNCS`)."""
    if opts is None:
        opts = fast_pass_opts(SolverOptions())
    ds, conds, x0 = _bind(spec, conds, None, device)
    return _fused(ds, conds, tof_mask, x0, opts, pos_tol, True)


def _warn_negative_tof(neg: int) -> None:
    if neg:
        warnings.warn(
            f"sweep_steady_state: net TOF is negative on {neg} lane(s) "
            "(selected steps run in reverse); 'activity' reports the "
            "|TOF| activity for those lanes. Inspect out['tof'] for "
            "signs.", stacklevel=5)


def _assemble_clean(res, quar, stable, tofs, act, check_stability: bool,
                    has_tof: bool, n_neg: int, lane_tel) -> dict:
    """The result dict, field for field as the JAX package's
    ``_assemble_clean``."""
    out = {"y": res.x, "success": res.success,
           "residual": res.residual, "iterations": res.iterations,
           "attempts": res.attempts, "quarantined": quar}
    for name in ("rate_ok", "pos_ok", "sums_ok", "dt_exit", "chords"):
        v = getattr(res, name, None)
        if v is not None:
            out[name] = v
    out["lane_telemetry"] = lane_tel
    if check_stability:
        out["stable"] = stable
        out["success"] = res.success & stable
    if has_tof:
        out["tof"] = tofs
        out["activity"] = act
        _warn_negative_tof(n_neg)
    return out


def _stability_tier2(ds: engine.DeviceSpec, conds: Conditions, ys,
                     idx: np.ndarray, certified: np.ndarray,
                     pos_tol: float) -> np.ndarray:
    """Tier-2 host eigensolve over the ambiguous lanes ``idx``: their
    Jacobians on the device, ``numpy.linalg.eigvals`` on the host, the
    verdicts merged into the host copy ``certified``, which is
    returned."""
    sel = torch.as_tensor(idx, device=ds.device)
    sub = Conditions(*(f[sel] for f in conds))
    J = engine.steady_jacobian(ds, sub, ys[sel][..., ds.dyn])
    Js = J.cpu().numpy()
    eig = np.linalg.eigvals(Js)
    scale = np.abs(Js).max(axis=(-2, -1))
    tol = stability_tolerance_from_scale(scale, pos_tol,
                                         float(np.finfo(Js.dtype).eps))
    certified[idx] = np.all(eig.real <= tol[..., None], axis=-1)
    return certified


def _rescue_needed(why: str):
    return NotImplementedError(
        f"sweep_steady_state: {why}; those lanes need the rescue ladder "
        "(multi-attempt solve, LM fallback, the legacy tail), which is "
        "not ported yet (ROADMAP Queue A item 7)")


def _decide(ds, conds, outs, check_stability: bool, has_tof: bool,
            pos_tol: float) -> dict:
    """The JAX package's ``_fused_decide`` on the fused outputs: one
    host sync of the bundle decides between the clean assembly and the
    tier-2-only escalation; anything else raises."""
    res, quar = outs[0], outs[1]
    pos = 2
    cert = amb = None
    if check_stability:
        cert, amb = outs[2], outs[3]
        pos = 4
    tofs = act = neg = None
    if has_tof:
        tofs, act, neg = outs[pos:pos + 3]
    lane_tel, bundle = outs[-2], outs[-1]
    nf, nq, n_amb, n_dem, n_neg = (int(c) for c in bundle.cpu().tolist())

    if nf == 0 and (not check_stability or (n_amb == 0 and n_dem == 0)):
        return _assemble_clean(res, quar, cert, tofs, act,
                               check_stability, has_tof, n_neg, lane_tel)
    if nf == 0 and check_stability and n_amb > 0 and n_dem == n_amb:
        idx = np.flatnonzero(amb.cpu().numpy())
        stable_h = _stability_tier2(ds, conds, res.x, idx,
                                    cert.cpu().numpy().copy(), pos_tol)
        if stable_h[idx].all():
            n_neg2 = int(neg.sum()) if has_tof else 0
            stable = torch.as_tensor(stable_h, device=res.x.device)
            return _assemble_clean(res, quar, stable, tofs, act,
                                   check_stability, has_tof, n_neg2,
                                   lane_tel)
        raise _rescue_needed(
            f"the host eigensolve demoted "
            f"{int((~stable_h[idx]).sum())} converged lane(s)")
    if nf:
        raise _rescue_needed(f"{nf} lane(s) failed the fast pass ({nq} of "
                             f"them quarantined)")
    raise _rescue_needed(f"{n_dem - n_amb} converged lane(s) have a "
                         f"non-finite Jacobian at the stability screen")


def sweep_steady_state(spec: ModelSpec, conds: Conditions, tof_mask=None,
                       x0=None, opts: SolverOptions = SolverOptions(),
                       mesh=None, check_stability: bool = False,
                       pos_jac_tol: float = 1e-2, abi: bool = False,
                       device=None) -> dict:
    """Steady state and optional TOF for every lane: the one-call sweep.

    Returns a dict with ``y [lanes, n_s]``, ``success``, ``residual``,
    ``iterations``, ``attempts``, ``quarantined``, ``rate_ok``,
    ``pos_ok``, ``sums_ok``, ``dt_exit``, ``chords`` and
    ``lane_telemetry [lanes, 5]``; with a ``tof_mask`` also ``tof`` and
    ``activity``; with ``check_stability`` also ``stable``, and
    converged lanes that are not certified stable are demoted to
    ``success=False``. Every value is a tensor on the sweep's device.

    ``abi=True`` lowers the mechanism into its ABI bucket first (the
    JAX package's ``PYCATKIN_ABI=1``) and runs the padded system, so
    the direction and certificate solves take the bucket-size kernels;
    a mechanism that fits no bucket warns and runs unpadded.
    ``device=None`` runs on the CUDA card; pass ``"cpu"`` for the CPU.
    ``mesh`` (multi-device lane sharding) is not ported and must be
    None. Raises ``NotImplementedError`` where the JAX package would
    rescue lanes (see the module doc)."""
    if mesh is not None:
        raise NotImplementedError("sweep_steady_state: multi-device lane "
                                  "sharding is not ported yet (ROADMAP "
                                  "Queue A item 12)")
    low = _abi.maybe_lower(spec) if abi else None
    if low is not None:
        spec, conds = low, low.pad_conditions(conds)
        tof_mask, x0 = low.pad_tof_mask(tof_mask), low.pad_x0(x0)
    ds, conds, x0 = _bind(spec, conds, x0, device)
    has_tof = tof_mask is not None
    outs = _fused(ds, conds, tof_mask, x0, fast_pass_opts(opts),
                  pos_jac_tol, check_stability)
    out = _decide(ds, conds, outs, check_stability, has_tof, pos_jac_tol)
    if low is not None:
        out["y"] = low.unpad_y(out["y"])
    return out
