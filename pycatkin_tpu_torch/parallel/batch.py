"""The fused steady-state sweep over a lane batch (PyTorch port of the
non-ABI ``_fused_sweep_program`` of ``pycatkin_tpu/parallel/batch.py``).

:func:`fused_sweep` runs the whole clean sweep of one mechanism over a
batch of conditions: the single-attempt PTC solve of every lane, the
per-lane NaN quarantine, the tier-0 stability certificate (Gershgorin,
then the deflated Lyapunov certificate where the deflated dimension is
1..8), TOF and activity, the packed per-lane telemetry and the packed
diagnostics bundle -- the same outputs in the same order as the JAX
program. Lanes that fail the fast pass are reported as failed; the
rescue ladder that would retry them is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import engine
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
                     pos_tol: float, Q=None):
    """Tier-0 stability certificate of every lane at full states ``ys``:
    Gershgorin on the dynamic Jacobian, OR the deflated Lyapunov
    certificate when ``Q`` (the deflation basis, 1 <= m <= 8) is given.
    Returns ``(cert, finite)`` bool tensors ``[L]``."""
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
    if Q is not None:
        cert = cert | (finite & lyapunov_certified_stable(
            J, Q, tol, eps_eff=effective_unit_roundoff(J.dtype)))
    return cert, finite


def fused_sweep(spec: ModelSpec, conds: Conditions, tof_mask=None,
                opts: SolverOptions | None = None, pos_tol: float = 1e-2,
                device=None):
    """The clean sweep of ``spec`` over the lane batch ``conds`` (every
    field with a leading lane dimension).

    ``opts`` are the pass's solver options, by default
    ``fast_pass_opts(SolverOptions())``; ``max_attempts`` must be 1 (the
    fast pass draws no random numbers). ``tof_mask [n_r]`` selects the
    TOF steps (None: no TOF/activity). ``device=None`` runs on the CUDA
    card and raises without one; pass ``"cpu"`` for the CPU.

    Returns, in the JAX program's order: ``res``
    (:class:`SteadyStateResults`, success already quarantine-demoted),
    ``quar``, ``cert``, ``amb``; with a TOF mask: ``tofs``, ``act``,
    ``neg``; then the ``[L, 5]`` int32 lane
    telemetry and the int32 diagnostics bundle ``[n_failed,
    n_quarantined, n_ambiguous, n_demoted, n_negative_tof]``. Everything
    stays on the device; the only host syncs are the solver loop's
    any-lane-active checks (:data:`solvers.newton.SYNCS`)."""
    dev = resolve_device(device)
    if opts is None:
        opts = fast_pass_opts(SolverOptions())
    ds = engine.bind(spec, dev)
    conds = engine.conditions_to(conds, dev)
    if conds.T.dim() != 1:
        raise ValueError("fused_sweep: conditions need a leading lane axis "
                         "(see broadcast_conditions)")

    res = engine.steady_state(ds, conds, opts=opts)
    finite_l = lane_finite_mask(res.x, res.residual)
    succ_raw = res.success
    quar = succ_raw & ~finite_l
    succ0 = succ_raw & finite_l
    res = res._replace(success=succ0)
    Q = deflation_basis_for_spec(spec)
    use_lyap = 0 < Q.shape[1] <= LYAPUNOV_MAX_DIM
    cert_raw, finite = stability_screen(ds, conds, res.x, pos_tol,
                                        Q if use_lyap else None)
    good = finite & succ0
    cert = good & cert_raw
    amb = good & ~cert
    demoted = succ0 & ~cert
    ok_spec = succ0 & cert
    outs = [res, quar, cert, amb]
    n_neg = None
    if tof_mask is not None:
        mask = torch.as_tensor(np.asarray(tof_mask, dtype=np.float64),
                               dtype=torch.float64, device=dev)
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
