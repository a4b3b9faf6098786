"""The fused steady-state sweep over a lane batch, the public one-call
sweep and the rescue ladder behind it (PyTorch port of
``_fused_sweep_program``, ``_abi_fused_body``, ``sweep_steady_state``,
``_finish_sweep`` and the entries that ride on them in
``pycatkin_tpu/parallel/batch.py``).

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
the JAX package's ``_fused_decide`` does -- assemble a clean result,
settle the ambiguous lanes by a host eigensolve, or hand the sweep to
:func:`_finish_sweep`: the rescue ladder over the failed lanes
(neighbor-seeded polish, the full PTC solve, LM), the quarantine
re-check, the stability verdict and up to three rounds of unseeded
re-solves of the lanes it demotes, then TOF and activity.
:func:`packed_sweep_steady_state` runs K mechanisms of one ABI bucket as
one lane batch (one PTC march, one bundle sync), each tenant's result
its solo sweep's. Under ``tier="f32-polish"`` the fast pass marches in
float32 and polishes and judges in float64 (:mod:`..precision`); the
screen, the certificate, TOF and the rescue tail stay float64.
:func:`batch_steady_state`, :func:`continuation_sweep`,
:func:`stability_mask` and :func:`stack_conditions` are the JAX
package's entries of the same names,
and so is :func:`batch_transient`, the lane-batched transient
(``engine.transient``) with its diagnostics bundle;
:func:`packed_batch_transient` integrates K mechanisms of one ABI bucket
as one lane batch, each tenant's answer its solo transient's.

The sweep tail carries the JAX package's hooks: every device stage runs
inside :func:`..utils.retry.call_with_backend_retry` under the JAX
package's label (``batched steady solve``, ``sweep tail``,
``rescue[<strategy>]``, ``neighbor-seed transfer``, ``stability
screen``, ``stability tier-2 jacobian``, ``tof/activity``, ``batched
transient sweep``), which is also the fault-injection site of that
stage; each rescue pass records a ``rescue`` event and the
``pycatkin_rescue_lanes_total`` / ``pycatkin_rescued_lanes_total``
counters, quarantined lanes go through ``ladder.record_quarantine``, and
every sweep counts ``pycatkin_lanes_solved_total`` and feeds the
per-lane histograms. Under an active fault plan the sweep takes the
split route (the first pass, then :func:`_finish_sweep`), as the JAX
package does, so a ``nan`` fault on the first pass's output meets the
quarantine; the two routes give the same bits.
"""

from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np
import torch

from .. import engine, precision
from ..frontend import abi as _abi
from ..obs import metrics as _metrics
from ..robustness import faults
from ..utils.profiling import host_sync, record_event, span
from ..utils.retry import call_with_backend_retry
from ..frontend.spec import Conditions, ModelSpec
from ..ops import prng
from ..solvers import ode
from ..solvers.ode import ODEOptions
from ..solvers import newton
from ..solvers.newton import (LYAPUNOV_MAX_DIM, STRATEGY_CODES,
                              SolverOptions, SteadyStateResults,
                              deflation_basis_for_spec,
                              effective_unit_roundoff, lane_finite_mask,
                              lyapunov_certified_stable,
                              packed_lane_telemetry,
                              packed_sweep_diagnostics,
                              stability_tolerance,
                              stability_tolerance_from_scale)


_LANE_COUNT_BUCKETS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                       500.0, 1000.0)
_LANE_DECADE_BUCKETS = (-16.0, -14.0, -12.0, -10.0, -8.0, -6.0, -4.0,
                        -2.0, 0.0)


def _note_lane_telemetry(tel: np.ndarray, ds: engine.DeviceSpec) -> None:
    """Feed one sweep's ``[lanes, 5]`` telemetry (host) into the per-lane
    histograms, labelled by the ABI bucket the sweep ran in
    (``unbucketed`` for an unpadded mechanism)."""
    bucket = str(ds.abi_fingerprint or "unbucketed")
    for name, help_text, col, buckets in (
            ("pycatkin_lane_iterations", "per-lane solver iteration counts",
             0, _LANE_COUNT_BUCKETS),
            ("pycatkin_lane_chords", "per-lane accepted chord re-solves",
             1, _LANE_COUNT_BUCKETS),
            ("pycatkin_lane_residual_decade",
             "per-lane final-residual decade (floor log10)", 2,
             _LANE_DECADE_BUCKETS)):
        _metrics.histogram(name, help_text, buckets=buckets).observe_many(
            tel[:, col], abi_bucket=bucket)


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


def stack_conditions(conds: list[Conditions]) -> Conditions:
    """Stack one-point Conditions into one lane batch (numpy arrays with
    a leading lane axis; the entries move them to the device)."""
    return Conditions(*(np.stack([np.asarray(v, dtype=np.float64)
                                  for v in fields])
                        for fields in zip(*conds)))


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


def _tier_column(succ0, tier: str):
    """The telemetry's tier column of a first pass: the tier's code on
    the lanes it accepted, 0 elsewhere."""
    code = torch.tensor(precision.TIER_CODES[tier], dtype=torch.int32,
                        device=succ0.device)
    return torch.where(succ0, code, torch.zeros_like(code))


def _fused(ds: engine.DeviceSpec, conds: Conditions, tof_mask, x0,
           opts: SolverOptions, pos_tol: float, check_stability: bool,
           tier: str = "f64"):
    """:func:`fused_sweep` on an already bound spec and device
    conditions, from the initial guess ``x0`` (None: ``conds.y0``),
    with or without the stability screen (without it, ``cert`` and
    ``amb`` are absent and the bundle reports -1 for their counts)."""
    res = engine.steady_state(ds, conds, x0=x0, opts=opts, tier=tier)
    return _fused_tail(ds, conds, res, tof_mask, pos_tol, check_stability,
                       tier)


def _fused_tail(ds: engine.DeviceSpec, conds: Conditions,
                res: SteadyStateResults, tof_mask, pos_tol: float,
                check_stability: bool, tier: str):
    """Everything :func:`_fused` computes after the steady solve ``res``:
    quarantine, screen, TOF, telemetry, bundle."""
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
                                      res.residual,
                                      tier=_tier_column(succ0, tier)))
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
                device=None, tier: str = "f64"):
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
    card and raises without one; pass ``"cpu"`` for the CPU. ``tier``:
    the precision tier of the steady solve (:mod:`..precision`).

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
    precision.check_tier(tier)
    ds, conds, x0 = _bind(spec, conds, None, device)
    with span("fused sweep"):
        return call_with_backend_retry(
            _fused, ds, conds, tof_mask, x0, opts, pos_tol, True, tier,
            label="batched steady solve")


def _warn_negative_tof(neg: int) -> None:
    if neg:
        warnings.warn(
            f"sweep_steady_state: net TOF is negative on {neg} lane(s) "
            "(selected steps run in reverse); 'activity' reports the "
            "|TOF| activity for those lanes. Inspect out['tof'] for "
            "signs.", stacklevel=6)


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

    def run_jac():
        J = engine.steady_jacobian(ds, engine.lane_subset(conds, sel),
                                   ys[sel][..., ds.dyn])
        return J.cpu().numpy()

    with span("tier-2 jacobian"):
        Js = call_with_backend_retry(run_jac,
                                     label="stability tier-2 jacobian")
    eig = np.linalg.eigvals(Js)
    certified[idx] = np.all(
        eig.real <= stability_tolerance(Js, pos_tol)[..., None], axis=-1)
    return certified


def _stability_mask(ds: engine.DeviceSpec, conds: Conditions, ys,
                    pos_tol: float, ok, precomputed=None):
    """:func:`stability_mask` on a bound spec: the tier-0 screen (or the
    ``precomputed`` ``(certified, ambiguous, n_ambiguous)`` of the same
    screen on the same ``ys`` and ``ok``), then the tier-2 host
    eigensolve on the ambiguous lanes. Returns a bool tensor ``[L]`` on
    the device."""
    if precomputed is not None:
        certified, ambiguous, n_amb = precomputed
    else:
        def run_screen():
            cert, finite = stability_screen(ds, conds, ys, pos_tol)
            good = finite & ok
            certified = good & cert
            ambiguous = good & ~certified
            return certified, ambiguous, int(ambiguous.sum())

        with span("stability screen"):
            certified, ambiguous, n_amb = call_with_backend_retry(
                run_screen, label="stability screen")
    if n_amb:
        idx = np.flatnonzero(ambiguous.cpu().numpy())
        out = _stability_tier2(ds, conds, ys, idx,
                               certified.cpu().numpy().copy(), pos_tol)
        return torch.as_tensor(out, device=ys.device)
    return certified


def stability_mask(spec, conds: Conditions, ys, pos_tol: float = 1e-2,
                   ok=None, precomputed=None, device=None):
    """``[lanes]`` Jacobian-eigenvalue stability verdict of the full
    states ``ys [lanes, n_s]``, two-tier: the tier-0 certificates on the
    device (Gershgorin, then the deflated Lyapunov witness), both sound
    one way, then ``numpy.linalg.eigvals`` on the host for the lanes
    they leave ambiguous. ``ok`` (``[lanes]`` bool) marks converged
    lanes; the others are reported unstable without an eigensolve.
    ``precomputed``: the ``(certified, ambiguous, n_ambiguous)`` of the
    same screen on the same states, which skips tier 0. ``spec`` is a
    :class:`ModelSpec` or an :class:`~..frontend.abi.AbiLowered` (states
    and conditions padded). Returns a bool tensor on the device."""
    ds, conds, _ = _bind(spec, conds, None, device)
    ys = torch.as_tensor(ys, dtype=torch.float64, device=ds.device)
    ok = torch.ones(ys.shape[0], dtype=torch.bool, device=ds.device) \
        if ok is None else torch.as_tensor(ok, device=ds.device).bool()
    return _stability_mask(ds, conds, ys, pos_tol, ok, precomputed)


def _quarantine_mask(res: SteadyStateResults, quarantined=None):
    """Per-lane NaN quarantine: lanes flagged converged whose state or
    residual is non-finite are demoted to failed. Returns ``(res,
    mask)``, the mask ORed into ``quarantined`` when given."""
    finite = lane_finite_mask(res.x, res.residual)
    q = res.success & ~finite
    if quarantined is not None:
        q = quarantined | q
    return res._replace(success=res.success & finite), q


def _neighbor_seed_lanes(conds: Conditions, success: np.ndarray):
    """For each failed lane, the index of the nearest converged lane in
    z-scored condition space (every condition field that varies across
    lanes), or None when no lane converged or none failed. Host numpy,
    with scipy's ``cKDTree`` where it imports."""
    n = len(success)
    fail_idx = np.flatnonzero(~success)
    ok_idx = np.flatnonzero(success)
    if len(ok_idx) == 0 or len(fail_idx) == 0:
        return None
    host_conds = call_with_backend_retry(
        lambda: [np.asarray(a.cpu() if torch.is_tensor(a) else a)
                 for a in conds], label="neighbor-seed transfer")
    feats = []
    for a in host_conds:
        if a.ndim >= 1 and a.shape[0] == n:
            f = a.reshape(n, -1).astype(np.float64)
            std = f.std(axis=0)
            varying = std > 0
            if varying.any():
                f = f[:, varying]
                feats.append((f - f.mean(axis=0)) / std[varying])
    if not feats:
        return None
    X = np.concatenate(feats, axis=1)
    try:
        from scipy.spatial import cKDTree
        _, nn = cKDTree(X[ok_idx]).query(X[fail_idx])
    except ImportError:
        nn = _chunked_nearest(X[fail_idx], X[ok_idx])
    out = np.arange(n)
    out[fail_idx] = ok_idx[nn]
    return out


def _chunked_nearest(Xf: np.ndarray, Xo: np.ndarray,
                     chunk: int = 128) -> np.ndarray:
    """``argmin_j |Xf_i - Xo_j|`` per row, in chunks of ``chunk`` rows
    (memory ``O(chunk * len(Xo))``)."""
    o2 = (Xo * Xo).sum(axis=1)
    nn = np.empty(len(Xf), dtype=np.int64)
    for s in range(0, len(Xf), chunk):
        f = Xf[s:s + chunk]
        d = (f * f).sum(axis=1)[:, None] + o2[None, :] - 2.0 * (f @ Xo.T)
        nn[s:s + chunk] = np.argmin(d, axis=1)
    return nn


def _polish_opts(opts: SolverOptions) -> SolverOptions:
    """Pacing of the seeded rescue polish: near-Newton from the first
    step, one attempt, a short cap."""
    return opts._replace(dt0=1.0e6, dt_grow_min=30.0, max_steps=60,
                         max_attempts=1)


def _rescue(ds: engine.DeviceSpec, conds: Conditions,
            res: SteadyStateResults, opts: SolverOptions, strategy: str,
            seed: int = 1, use_x0: bool = True, neighbor_seed: bool = False,
            n_failed: int | None = None, codes: np.ndarray | None = None,
            code: int = 0):
    """Re-solve the failed lanes of ``res`` with ``strategy`` at ``opts``.

    The failed lanes are gathered (the JAX package pads the subset to a
    power of two to bound its compiled shapes; nothing here compiles per
    shape, so the subset runs as it is) and lane ``i`` of the subset
    takes key ``i`` of ``split(prng_key(seed), n)``, the key the JAX
    package gives it: the first keys of a split do not depend on its
    count. ``use_x0`` seeds each lane from its own iterate, or with
    ``neighbor_seed`` from the nearest converged lane's
    (:func:`_neighbor_seed_lanes`); ``use_x0=False`` restarts from the
    base state. Recovered lanes take the rescue's state, verdict,
    residual and forensic fields, and ``codes[lane] = code`` (host
    int32 array); iterations, attempts and chords accumulate over every
    failed lane. ``n_failed``: the failed count if already known.
    Returns ``(res, n_remaining)``."""
    if n_failed is None:
        n_failed = int((~res.success).sum())
    if n_failed == 0:
        return res, 0
    success = res.success.cpu().numpy()
    idx = np.flatnonzero(~success)
    seed_lane = idx
    if use_x0 and neighbor_seed:
        nn = _neighbor_seed_lanes(conds, success)
        if nn is not None:
            seed_lane = nn[idx]
    dev = res.x.device
    sel = torch.as_tensor(idx, device=dev)

    def run_rescue():
        keys = prng.split(prng.prng_key(seed, dev), len(idx))
        x0 = res.x[torch.as_tensor(seed_lane, device=dev)][:, ds.dyn] \
            if use_x0 else None
        o = engine.steady_state(ds, engine.lane_subset(conds, sel), x0=x0,
                                key=keys, opts=opts, strategy=strategy)
        return o, o.success.cpu().numpy()

    label = f"rescue[{strategy}]"
    with span(label):
        out, got = call_with_backend_retry(run_rescue, label=label)
    n_remaining = int(n_failed - got.sum())
    record_event("rescue", label=label, n_failed=int(n_failed),
                 n_remaining=n_remaining)
    _metrics.counter("pycatkin_rescue_lanes_total",
                     "failed lanes entering each rescue strategy").inc(
                         int(n_failed), strategy=str(strategy))
    _metrics.counter("pycatkin_rescued_lanes_total",
                     "lanes recovered per rescue strategy").inc(
                         int(n_failed) - n_remaining,
                         strategy=str(strategy))
    if not got.any():
        return res, n_remaining
    got_d = out.success
    won = sel[got_d]
    fields = {}
    for name in ("x", "residual", "rate_ok", "pos_ok", "sums_ok",
                 "dt_exit"):
        fields[name] = getattr(res, name).clone()
        fields[name][won] = getattr(out, name)[got_d]
    for name in ("iterations", "attempts", "chords"):
        fields[name] = getattr(res, name).clone()
        fields[name][sel] += getattr(out, name)
    succ = res.success.clone()
    succ[won] = True
    if codes is not None:
        codes[idx[got]] = np.int32(code)
    return res._replace(success=succ, **fields), n_remaining


def _host_lane_telemetry(res: SteadyStateResults, quar, strategy_codes,
                         first_pass_tier: int = 0):
    """The ``[L, 5]`` int32 lane telemetry of a sweep that ran the
    rescue ladder, built on the host as the JAX package's failure path
    builds it: the strategy column holds each lane's ladder code (6 on a
    quarantined lane); the tier column holds ``first_pass_tier``, the
    first pass's tier code, on the lanes that pass accepted (converged,
    strategy 0) and 0 on every other (the ladder is float64). Returned
    on the host."""
    it = res.iterations.cpu().numpy().astype(np.int32)
    ch = res.chords.cpu().numpy().astype(np.int32)
    r = res.residual.cpu().numpy().astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        dec = np.floor(np.log10(np.where(r > 0, r, 1.0)))
    dec = np.where(r > 0, dec, -99.0)
    dec = np.where(np.isfinite(r), dec, 99.0)
    dec = np.clip(dec, -99, 99).astype(np.int32)
    strat = np.where(quar.cpu().numpy(),
                     np.int32(STRATEGY_CODES["quarantine"]),
                     np.asarray(strategy_codes, dtype=np.int32))
    strat = strat.astype(np.int32)
    ok = res.success.cpu().numpy().astype(bool)
    tcol = np.where(ok & (strat == 0), np.int32(first_pass_tier),
                    np.int32(0)).astype(np.int32)
    return np.stack([it, ch, dec, strat, tcol], axis=-1)


def _tof_activity(ds: engine.DeviceSpec, conds: Conditions, ys, tof_mask,
                  ok):
    """TOF and activity of every lane at ``ys``, and the count of lanes
    with ``ok`` and a finite negative TOF."""
    mask = torch.as_tensor(np.asarray(tof_mask, dtype=np.float64),
                           dtype=torch.float64, device=ds.device)
    tofs = engine.tof(ds, conds, ys, mask)
    act = engine.activity_from_tof(tofs, conds.T)
    n_neg = int((ok & torch.isfinite(tofs) & (tofs < 0.0)).sum())
    return tofs, act, n_neg


def _finish_sweep(ds: engine.DeviceSpec, conds: Conditions,
                  res: SteadyStateResults, opts: SolverOptions, tof_mask,
                  check_stability: bool, pos_tol: float,
                  screen=None, tier: str = "f64") -> dict:
    """The sweep tail after the first solving pass (the JAX package's
    ``_finish_sweep``): the quarantine, then -- on a clean pass -- the
    result as is, else the rescue ladder (neighbor-seeded polish, the
    full PTC solve, LM), the quarantine re-check, with
    ``check_stability`` the stability verdict (reusing the tier-0 screen
    when the ladder did not run) and up to three rounds in which every
    failed lane is re-solved unseeded and the verdict taken again; last,
    TOF and activity with ``ok = success & stable``. ``screen``: the
    ``(certified, ambiguous)`` tier-0 screen of ``res`` already computed
    (the fused sweep's). ``tier``: the precision tier of the first pass,
    whose code the telemetry's tier column carries on the lanes that pass
    accepted. Returns the result dict."""
    has_tof = tof_mask is not None
    res, quar = _quarantine_mask(res)

    def run_tail():
        # The counts, and on a clean sweep its TOF and telemetry, in one
        # retried unit (the JAX package's speculative tail).
        nf = int((~res.success).sum())
        cert = amb = None
        n_amb = n_dem = 0
        if check_stability:
            if screen is None:
                c, finite = stability_screen(ds, conds, res.x, pos_tol)
                good = finite & res.success
                cert, amb = good & c, good & ~c
            else:
                cert, amb = screen
            n_amb = int(amb.sum())
            n_dem = int((res.success & ~cert).sum())
        if nf or (check_stability and (n_amb or n_dem)):
            return nf, cert, amb, n_amb, None
        tofs = act = None
        n_neg = 0
        if has_tof:
            ok = res.success & cert if check_stability else res.success
            tofs, act, n_neg = _tof_activity(ds, conds, res.x, tof_mask,
                                             ok)
        tel = packed_lane_telemetry(res.iterations, res.chords,
                                    res.residual,
                                    tier=_tier_column(res.success, tier))
        return nf, cert, amb, n_amb, (tofs, act, n_neg, tel,
                                      host_sync(tel, "sweep tail bundle"))

    with span("sweep tail"):
        nf, cert, amb, n_amb, clean = call_with_backend_retry(
            run_tail, label="sweep tail")
    if clean is not None:
        tofs, act, n_neg, tel, tel_h = clean
        _note_lane_telemetry(tel_h, ds)
        return _assemble_clean(res, quar, cert, tofs, act, check_stability,
                               has_tof, n_neg, tel)

    nf0 = nf
    strat = np.zeros(len(conds.T), dtype=np.int32)
    if nf > 0:
        res, nf = _rescue(ds, conds, res, _polish_opts(opts), "ptc",
                          neighbor_seed=True, n_failed=nf, codes=strat,
                          code=STRATEGY_CODES["polish"])
    if nf > 0:
        res, nf = _rescue(ds, conds, res, opts, "ptc", neighbor_seed=True,
                          n_failed=nf, codes=strat,
                          code=STRATEGY_CODES["ptc"])
    if nf > 0:
        res, nf = _rescue(ds, conds, res, opts, "lm", n_failed=nf,
                          codes=strat, code=STRATEGY_CODES["lm"])
    if nf0 > 0:
        res, quar = _quarantine_mask(res, quar)
    q_lanes = np.flatnonzero(quar.cpu().numpy())
    if q_lanes.size:
        from ..robustness.ladder import record_quarantine
        record_quarantine(q_lanes.tolist(), label="quarantine:sweep")
    stable = None
    if check_stability:
        pre = (cert, amb, n_amb) if nf0 == 0 else None
        stable = _stability_mask(ds, conds, res.x, pos_tol, res.success,
                                 precomputed=pre)
        for round_i in range(3):
            if int((res.success & ~stable).sum()) == 0:
                break
            res = res._replace(success=res.success & stable)
            res, _ = _rescue(ds, conds, res, opts, "ptc", seed=17 + round_i,
                             use_x0=False, codes=strat,
                             code=STRATEGY_CODES["demote"])
            stable = _stability_mask(ds, conds, res.x, pos_tol, res.success)
    out = {"y": res.x, "success": res.success, "residual": res.residual,
           "iterations": res.iterations, "attempts": res.attempts,
           "quarantined": quar}
    for name in ("rate_ok", "pos_ok", "sums_ok", "dt_exit", "chords"):
        v = getattr(res, name, None)
        if v is not None:
            out[name] = v
    tel = _host_lane_telemetry(res, quar, strat, precision.TIER_CODES[tier])
    out["lane_telemetry"] = torch.as_tensor(tel, device=res.x.device)
    _note_lane_telemetry(tel, ds)
    if check_stability:
        out["stable"] = stable
        out["success"] = res.success & stable
    if has_tof:
        with span("tof/activity"):
            out["tof"], out["activity"], n_neg = call_with_backend_retry(
                _tof_activity, ds, conds, res.x, tof_mask, out["success"],
                label="tof/activity")
        _warn_negative_tof(n_neg)
    return out


def _pull_bundles(outs, label: str):
    """The lane telemetry and diagnostics bundle of each fused output in
    ``outs``, moved to the host in one counted sync (one
    ``newton.SYNCS["sweep_bundle"]``). Returns ``[(tel, counts)]``."""
    newton.SYNCS["sweep_bundle"] += 1
    got = host_sync([(o[-2], o[-1]) for o in outs], label)
    return [(tel, bundle.tolist()) for tel, bundle in got]


def _decide(ds, conds, outs, opts: SolverOptions, tof_mask,
            check_stability: bool, pos_tol: float, tier: str,
            tel_host: np.ndarray, counts) -> dict:
    """The JAX package's ``_fused_decide`` on the fused outputs: the
    bundle's values ``counts`` (and the lane telemetry ``tel_host``,
    pulled with it: :func:`_pull_bundles`) decide between the clean
    assembly, the tier-2-only escalation and the rescue tail
    (:func:`_finish_sweep`, from the raw fast-pass result)."""
    has_tof = tof_mask is not None
    res, quar = outs[0], outs[1]
    pos = 2
    cert = amb = None
    if check_stability:
        cert, amb = outs[2], outs[3]
        pos = 4
    tofs = act = neg = None
    if has_tof:
        tofs, act, neg = outs[pos:pos + 3]
    lane_tel = outs[-2]
    nf, nq, n_amb, n_dem, n_neg = (int(c) for c in counts)
    if check_stability and n_amb > 0:
        _metrics.counter(
            "pycatkin_tier2_escalations_total",
            "tier-0 certificate abstentions escalated to the tier-2 "
            "eigensolve").inc(n_amb)

    if nf == 0 and (not check_stability or (n_amb == 0 and n_dem == 0)):
        _note_lane_telemetry(tel_host, ds)
        return _assemble_clean(res, quar, cert, tofs, act,
                               check_stability, has_tof, n_neg, lane_tel)
    if nf == 0 and check_stability and n_amb > 0 and n_dem == n_amb:
        idx = np.flatnonzero(amb.cpu().numpy())
        stable_h = _stability_tier2(ds, conds, res.x, idx,
                                    cert.cpu().numpy().copy(), pos_tol)
        if stable_h[idx].all():
            n_neg2 = int(neg.sum()) if has_tof else 0
            stable = torch.as_tensor(stable_h, device=res.x.device)
            _note_lane_telemetry(tel_host, ds)
            return _assemble_clean(res, quar, stable, tofs, act,
                                   check_stability, has_tof, n_neg2,
                                   lane_tel)
    res_raw = res._replace(success=res.success | quar)
    return _finish_sweep(ds, conds, res_raw, opts, tof_mask,
                         check_stability, pos_tol,
                         screen=(cert, amb) if check_stability else None,
                         tier=tier)


def _no_mesh(entry: str, mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(f"{entry}: multi-device lane sharding is "
                                  "not ported yet (ROADMAP Queue A item 12)")


def sweep_steady_state(spec: ModelSpec, conds: Conditions, tof_mask=None,
                       x0=None, opts: SolverOptions = SolverOptions(),
                       mesh=None, check_stability: bool = False,
                       pos_jac_tol: float = 1e-2, abi: bool = False,
                       device=None, tier: str = "f64") -> dict:
    """Steady state and optional TOF for every lane: the one-call sweep.

    Returns a dict with ``y [lanes, n_s]``, ``success``, ``residual``,
    ``iterations``, ``attempts``, ``quarantined``, ``rate_ok``,
    ``pos_ok``, ``sums_ok``, ``dt_exit``, ``chords`` and
    ``lane_telemetry [lanes, 5]``; with a ``tof_mask`` also ``tof`` and
    ``activity``; with ``check_stability`` also ``stable``, and
    converged lanes that are not stable are demoted to
    ``success=False``. Every value is a tensor on the sweep's device.
    Lanes that fail the capped first pass, are quarantined or are
    demoted by the stability verdict go through the rescue ladder (see
    the module doc), as in the JAX package.

    ``abi=True`` lowers the mechanism into its ABI bucket first (the
    JAX package's ``PYCATKIN_ABI=1``) and runs the padded system, so
    the direction and certificate solves take the bucket-size kernels;
    a mechanism that fits no bucket warns and runs unpadded; an
    :class:`~..frontend.abi.AbiLowered` ``spec`` runs as lowered (with
    unpadded ``conds``, ``tof_mask`` and ``x0``).
    ``device=None`` runs on the CUDA card; pass ``"cpu"`` for the CPU.
    ``tier``: the precision tier of the fast pass (``"f64"`` or
    ``"f32-polish"``, :mod:`..precision`): under ``"f32-polish"`` it
    marches in float32, polishes in float64 and takes the float64
    verdict, and the telemetry's tier column carries code 1 on the lanes
    it accepted; the screen, the certificate, TOF and the rescue ladder
    stay float64, so the verdicts are the float64 sweep's.
    ``mesh`` (multi-device lane sharding) is not ported and must be
    None."""
    _no_mesh("sweep_steady_state", mesh)
    precision.check_tier(tier)
    low = spec if isinstance(spec, _abi.AbiLowered) else \
        _abi.maybe_lower(spec) if abi else None
    if low is not None:
        _metrics.counter(
            "pycatkin_abi_bucket_sweeps_total",
            "sweeps dispatched per ABI shape bucket").inc(
                bucket=low.abi_fingerprint)
        spec, conds = low, low.pad_conditions(conds)
        tof_mask, x0 = low.pad_tof_mask(tof_mask), low.pad_x0(x0)
    ds, conds, x0 = _bind(spec, conds, x0, device)
    _metrics.counter("pycatkin_lanes_solved_total",
                     "lanes entering sweep_steady_state").inc(len(conds.T))
    t0 = time.perf_counter()
    try:
        out = _sweep_tail(ds, conds, tof_mask, x0, opts, check_stability,
                          pos_jac_tol, tier)
    finally:
        _metrics.histogram(
            "pycatkin_sweep_wall_seconds",
            "sweep_steady_state wall time").observe(
                time.perf_counter() - t0)
    if low is not None:
        out["y"] = low.unpad_y(out["y"])
    return out


def _sweep_tail(ds, conds, tof_mask, x0, opts: SolverOptions,
                check_stability: bool, pos_tol: float, tier: str) -> dict:
    """:func:`sweep_steady_state` on a bound spec: the fused pass and its
    bundle in one retried unit, then :func:`_decide`; under an active
    fault plan the first pass alone (a ``nan`` fault poisons its
    output), then :func:`_finish_sweep`."""
    fast = fast_pass_opts(opts)
    if faults.active_plan() is not None:
        with span("solve dispatch"):
            res = call_with_backend_retry(
                engine.steady_state, ds, conds, x0=x0, opts=fast, tier=tier,
                label="batched steady solve")
        return _finish_sweep(ds, conds, res, opts, tof_mask,
                             check_stability, pos_tol, tier=tier)

    def run_fused():
        outs = _fused(ds, conds, tof_mask, x0, fast, pos_tol,
                      check_stability, tier)
        return outs, _pull_bundles([outs], "fused tail bundle")[0]

    with span("fused sweep"):
        outs, (tel, counts) = call_with_backend_retry(
            run_fused, label="batched steady solve")
    return _decide(ds, conds, outs, opts, tof_mask, check_stability,
                   pos_tol, tier, tel, counts)


def _lane_closures(fns):
    """One closure over a tenant-major lane batch from the K tenants'
    closures ``fns``: each evaluates a fresh copy of its tenant's block of
    lanes (as its solo batch would: see ``newton._per_tenant``), the
    results (a tensor, or a pair) concatenated along the lanes."""
    K = len(fns)

    def call(x):
        outs = [f(xk.clone()) for f, xk in zip(fns, x.chunk(K))]
        if isinstance(outs[0], tuple):
            return tuple(torch.cat(o) for o in zip(*outs))
        return torch.cat(outs)
    return call


def _stack_tenants(ts):
    """The tenants' tensors (one shape, one dense layout) on a new leading
    axis, each slice laid out as its source: a solo batch uses its groups
    as they are (``DeviceSpec.groups_dyn`` is column-major), and cuBLAS
    takes another kernel, with another float32 rounding on an H100, for
    the transposed layout of the same group sums."""
    t0 = ts[0]
    out = torch.empty_strided((len(ts),) + tuple(t0.shape),
                              (t0.numel(),) + t0.stride(), dtype=t0.dtype,
                              device=t0.device)
    for o, t in zip(out, ts):
        o.copy_(t)
    return out


def _packed_fast_pass(dss, conds, x0s, opts: SolverOptions, tier: str):
    """The single-attempt solve of K bound tenants (same bucket, same
    lane count) as one lane batch, tenant-major: each tenant's rate
    constants, closures and (under ``f32-polish``) bulk closures are its
    solo sweep's, evaluated on its block of lanes; the march, its
    any-lane-active syncs and its kernel launches are shared, and the
    groups are stacked ``[K, n_g, n]`` (see ``solvers.newton``). Returns
    each tenant's :class:`SteadyStateResults` (copies of its lanes of the
    batch's per-lane tensors, states composed per tenant)."""
    K = len(dss)
    fs, js, bulk, x0 = [], [], [], []
    for ds, c, x in zip(dss, conds, x0s):
        kf, kr, _ = engine.rate_constants(ds, c)
        cl = engine.closures(ds, c, kf, kr)
        fs.append(cl.fscale)
        js.append(cl.jac)
        bulk.append(engine.bulk_closures(ds, c, kf, kr, tier))
        x0.append(cl.y_base[..., ds.dyn] if x is None else x)
    bulk_fns = None if bulk[0] is None else (
        _lane_closures([b[0] for b in bulk]),
        _lane_closures([b[1] for b in bulk]))
    out = newton.solve_steady(
        _lane_closures(fs), _lane_closures(js), torch.cat(x0).contiguous(),
        _stack_tenants([ds.groups_dyn for ds in dss]), opts, tier=tier,
        bulk_fns=bulk_fns)
    per = [t.chunk(K) for t in out]
    return [SteadyStateResults(engine.compose_state(ds, c.y0, per[0][k]),
                               *(p[k].clone() for p in per[1:]))
            for k, (ds, c) in enumerate(zip(dss, conds))]


def _packed_fused(dss, conds, masks, x0s, opts: SolverOptions,
                  pos_tol: float, check_stability: bool, tier: str):
    """The packed fast pass, each tenant's fused tail (quarantine, screen,
    TOF, telemetry, bundle) on its own results, ONE sync of the K
    bundles, then each tenant's :func:`_decide`: a clean tenant assembles
    from its slices, a dirty one escalates through its own solo tail
    without touching its co-tenants' results."""
    res = _packed_fast_pass(dss, conds, x0s, fast_pass_opts(opts), tier)
    outs = [_fused_tail(ds, c, r, m, pos_tol, check_stability, tier)
            for ds, c, r, m in zip(dss, conds, res, masks)]
    pulled = _pull_bundles(outs, "packed fused bundle")
    return [_decide(ds, c, o, opts, m, check_stability, pos_tol, tier,
                    tel, n)
            for ds, c, o, m, (tel, n) in zip(dss, conds, outs, masks,
                                              pulled)]


def packed_sweep_steady_state(specs, conds, tof_mask=None, x0=None,
                              opts: SolverOptions = SolverOptions(),
                              check_stability: bool = False,
                              pos_jac_tol: float = 1e-2, tier: str = "f64",
                              device=None) -> list:
    """Multi-tenant :func:`sweep_steady_state` (the JAX package's
    ``packed_sweep_steady_state``): K mechanisms that lower into one ABI
    bucket run their fast pass as one lane batch (one PTC march, one
    kernel launch a step, one bundle sync) and come back as a list of
    per-tenant result dicts, each equal to that mechanism's solo
    ``sweep_steady_state(..., abi=True)`` (``torch.equal`` on every key;
    ``y`` unpadded).

    ``conds`` / ``tof_mask`` / ``x0`` are one value shared by every
    tenant or a sequence of one per tenant; the tenants must share a lane
    count. ``tof_mask`` and ``x0`` are given for every tenant or for
    none. One tenant runs its solo sweep; a mechanism that fits no bucket
    sends every tenant to its solo sweep; tenants of different buckets
    raise :class:`~..frontend.abi.AbiBucketError`. ``tier`` and
    ``device`` as for :func:`sweep_steady_state`."""
    precision.check_tier(tier)
    specs = list(specs)
    k = len(specs)
    if k == 0:
        return []

    def per_tenant(v, name):
        shared = not isinstance(v, (list, tuple)) or isinstance(v,
                                                                Conditions)
        vs = [v] * k if shared else list(v)
        if len(vs) != k:
            raise ValueError(f"{name}: {len(vs)} entries for {k} tenants")
        return vs

    conds_list = per_tenant(conds, "conds")
    masks = per_tenant(tof_mask, "tof_mask")
    x0s = per_tenant(x0, "x0")

    def solo(specs):
        # An AbiLowered runs as lowered; a spec that fits no bucket (its
        # maybe_lower warned) runs unpadded.
        return [sweep_steady_state(s, c, m, x, opts=opts,
                                   check_stability=check_stability,
                                   pos_jac_tol=pos_jac_tol, device=device,
                                   tier=tier)
                for s, c, m, x in zip(specs, conds_list, masks, x0s)]

    lows = [s if isinstance(s, _abi.AbiLowered) else _abi.maybe_lower(s)
            for s in specs]
    if k == 1 or any(low is None for low in lows):
        return solo([s if low is None else low
                     for s, low in zip(specs, lows)])
    _abi.pack_lowered(lows)
    lanes = [len(c.T) for c in conds_list]
    if len(set(lanes)) != 1:
        raise ValueError(f"packed tenants must share a lane count, got "
                         f"{lanes}")
    for name, vals in (("tof_mask", masks), ("x0", x0s)):
        if len({v is None for v in vals}) != 1:
            raise ValueError(f"{name} must be given for every tenant or "
                             f"none")
    bound = [_bind(low, low.pad_conditions(c), low.pad_x0(x), device)
             for low, c, x in zip(lows, conds_list, x0s)]
    dss, conds_t, x0_t = (list(v) for v in zip(*bound))
    outs = _packed_fused(dss, conds_t,
                         [low.pad_tof_mask(m) for low, m in zip(lows, masks)],
                         x0_t, opts, pos_jac_tol, check_stability, tier)
    for low, out in zip(lows, outs):
        out["y"] = low.unpad_y(out["y"])
    return outs


def batch_steady_state(spec: ModelSpec, conds: Conditions, x0=None,
                       opts: SolverOptions = SolverOptions(), mesh=None,
                       abi: bool = False, device=None,
                       tier: str = "f64") -> SteadyStateResults:
    """Solve the steady state of every lane in one call (the JAX
    package's ``batch_steady_state``): ``engine.steady_state`` at
    ``opts`` with lane ``i`` keyed by row ``i`` of ``split(prng_key(0),
    lanes)``. ``x0``: optional ``[lanes, n_dyn]`` initial guesses;
    ``abi`` lowers into the ABI bucket first (``y`` comes back
    unpadded). ``tier`` is the precision tier, which only a
    single-attempt ``opts`` uses (see ``engine.steady_state``). Returns a
    lane-batched :class:`SteadyStateResults` on the device; ``mesh`` must
    be None."""
    _no_mesh("batch_steady_state", mesh)
    low = _abi.maybe_lower(spec) if abi else None
    if low is not None:
        spec, conds, x0 = low, low.pad_conditions(conds), low.pad_x0(x0)
    ds, conds, x0 = _bind(spec, conds, x0, device)
    keys = prng.split(prng.prng_key(0, ds.device), len(conds.T))
    res = engine.steady_state(ds, conds, x0=x0, key=keys, opts=opts,
                              tier=tier)
    if low is not None:
        res = res._replace(x=low.unpad_y(res.x))
    return res


def continuation_sweep(spec: ModelSpec, conds: Conditions, order,
                       tof_mask=None, opts: SolverOptions = SolverOptions(),
                       stage_opts: SolverOptions | None = None,
                       check_stability: bool = False,
                       pos_jac_tol: float = 1e-2, abi: bool = False,
                       device=None) -> dict:
    """Warm-started sweep along a continuation axis (the JAX package's
    ``continuation_sweep``). ``order [n_stages, m]`` holds every lane
    index exactly once; stage 0 solves its lanes cold at the fast-pass
    options, every later stage from the previous stage's solutions at
    ``stage_opts`` (default: near-Newton, ``dt0=1``, ``dt_grow_min=10``,
    60 steps, one attempt). Stage ``s`` keys its lanes with rows ``s m
    .. (s + 1) m`` of ``split(prng_key(0), n_stages m)``. The stages are
    then put back in lane order and finished by the sweep's tail, the
    rescue ladder included. Returns the dict of
    :func:`sweep_steady_state`."""
    low = _abi.maybe_lower(spec) if abi else None
    if low is not None:
        spec, conds = low, low.pad_conditions(conds)
        tof_mask = low.pad_tof_mask(tof_mask)
    ds, conds, _ = _bind(spec, conds, None, device)
    order = np.asarray(order)
    n_stages, m = order.shape
    n_lanes = len(conds.T)
    if not np.array_equal(np.sort(order.ravel()), np.arange(n_lanes)):
        raise ValueError(
            "continuation_sweep: `order` must contain every lane index "
            f"exactly once (got shape {order.shape} for {n_lanes} lanes)")
    first = fast_pass_opts(opts)
    cont = stage_opts or opts._replace(dt0=1.0, dt_grow_min=10.0,
                                       max_steps=60, max_attempts=1)
    keys = prng.split(prng.prng_key(0, ds.device), n_stages * m)
    stages = []
    for s in range(n_stages):
        sub = engine.lane_subset(conds, order[s])
        x0 = None if s == 0 else stages[-1].x[:, ds.dyn]
        stages.append(call_with_backend_retry(
            engine.steady_state, ds, sub, x0=x0, key=keys[s * m:(s + 1) * m],
            opts=first if s == 0 else cont,
            label=f"continuation stage {s}"))
    inv = torch.as_tensor(np.argsort(order.ravel()), device=ds.device)
    res = SteadyStateResults(*(torch.cat(leaves)[inv]
                               for leaves in zip(*stages)))
    out = _finish_sweep(ds, conds, res, opts, tof_mask, check_stability,
                        pos_jac_tol)
    if low is not None:
        out["y"] = low.unpad_y(out["y"])
    return out


def batch_transient(spec: ModelSpec, conds: Conditions, save_ts,
                    opts: ODEOptions = ODEOptions(), mesh=None,
                    chunk: int = 8, abi: bool = False, device=None,
                    diagnostics: Optional[dict] = None, fused: bool = True,
                    force_chunking: bool = False):
    """Integrate every lane's transient over the save grid ``save_ts``
    (``save_ts[0]`` the initial time) and finish it by Newton, as the
    JAX package's fused transient does. Returns ``(ys [lanes, t, n_s],
    ok [lanes])`` on the device.

    Given a dict ``diagnostics``, fills it with the sweep's diagnostics
    bundle (``packed_sweep_diagnostics``), pulled by one sync:
    ``failed``, the lanes not ``ok`` or with a non-finite last point,
    and ``quarantined``, the lanes with a non-finite last point. A
    quarantined count above 0 records a ``transient:nonfinite``
    degradation event, as the JAX package does; on the fused route, which
    keeps ``ys`` on the device, the count is taken only when
    ``diagnostics`` asks for the bundle.

    Routes, as in the JAX package: the fused route integrates the whole
    save grid in one call (``engine.transient``, retried under the label
    ``batched transient sweep``); with ``fused=False`` (the JAX
    package's ``PYCATKIN_FUSED_TRANSIENT=0``) or under an active fault
    plan the chunked route drives the grid from the host in blocks of
    ``chunk`` save times (``engine.chunked_transient_drive``: one
    counted pull of each block's states), which off a TPU is one block
    unless ``force_chunking``. Both routes give the same ``ys`` and
    ``ok`` bit for bit.

    ``abi=True`` lowers the mechanism into its ABI bucket first (the
    JAX package's ``PYCATKIN_ABI=1``), runs the padded system, whose
    stage matrices are then of the bucket's size S, and strips the pad
    species from ``ys``. ``mesh`` must be None. ``device=None`` runs on
    the CUDA card; pass ``"cpu"`` for the CPU."""
    _no_mesh("batch_transient", mesh)
    low = _abi.maybe_lower(spec) if abi else None
    if low is not None:
        spec, conds = low, low.pad_conditions(conds)
    ds, conds, _ = _bind(spec, conds, None, device)
    n_quar = None
    if fused and faults.active_plan() is None:
        with span("fused transient sweep", lanes=len(conds.T),
                  save_pts=len(save_ts)):
            ys, ok = call_with_backend_retry(
                engine.transient, ds, conds, save_ts, opts,
                label="batched transient sweep")
    else:
        with span("chunked transient sweep", lanes=len(conds.T),
                  save_pts=len(save_ts)):
            ys, ok = engine.transient_chunked(
                ds, conds, save_ts, opts, chunk=chunk,
                force_chunking=force_chunking)
        if diagnostics is None:
            n_quar = int((~torch.isfinite(ys[:, -1, :]).all(dim=-1)).sum())
    if diagnostics is not None:
        finite = torch.all(torch.isfinite(ys[:, -1, :]), dim=-1)
        bundle = packed_sweep_diagnostics(ok & finite, ~finite)
        ode.SYNCS["transient_bundle"] += 1
        failed, n_quar = bundle[:2].tolist()
        diagnostics.update(failed=failed, quarantined=n_quar)
    if n_quar:
        record_event("degradation", label="transient:nonfinite",
                     detail="transient lanes with non-finite endpoints",
                     lanes=n_quar)
    if low is not None:
        ys = low.unpad_y(ys)
    return ys, ok


def _packed_transient_lanes(tenant_lanes, L: int):
    """The integrator's ``lanes(idx)`` over K tenants' lanes stacked
    tenant-major (``L`` each) from their own ``lanes`` closures. ``idx``
    (host, ascending) splits into each tenant's block; a tenant with no
    lane in it is skipped, one with all ``L`` lanes takes its closures
    over every lane (``lanes(None)``, as its solo run does until a lane
    stops), and each evaluates a fresh copy of its rows, so every
    closure sees its solo run's shapes and layout; ``blocks`` carries
    the tenants' lane counts to the step controller (``ode._blockwise``)."""
    K = len(tenant_lanes)

    def lanes(idx=None):
        if idx is None:
            parts = [(fn(None), L) for fn in tenant_lanes]
        else:
            cut = np.searchsorted(idx, np.arange(K + 1) * L)
            parts = []
            for k, fn in enumerate(tenant_lanes):
                n = int(cut[k + 1] - cut[k])
                if n:
                    parts.append((fn(None if n == L else
                                     idx[cut[k]:cut[k + 1]] - k * L), n))
        fns = [p for p, _ in parts]
        sizes = [n for _, n in parts]

        def each(name):
            def call(y):
                outs = [getattr(f, name)(yk.clone())
                        for f, yk in zip(fns, y.split(sizes))]
                if isinstance(outs[0], tuple):
                    return tuple(torch.cat(o) for o in zip(*outs))
                return torch.cat(outs)
            return call
        return ode.OdeFns(f=each("f"), jac=each("jac"),
                          oracles=each("oracles"), blocks=tuple(sizes))
    return lanes


def packed_batch_transient(specs, conds, save_ts,
                           opts: ODEOptions = ODEOptions(), chunk: int = 8,
                           device=None) -> list:
    """Multi-tenant :func:`batch_transient` (the JAX package's
    ``packed_batch_transient``): K mechanisms that lower into one ABI
    bucket integrate over one shared save grid as one lane batch, one
    step loop with one stage-matrix ``lu_factor`` launch and one counted
    sync a batch step, and come back as a list of per-tenant ``(ys,
    ok)``, each bit for bit that mechanism's solo ``batch_transient(...,
    abi=True)`` (``ys`` unpadded).

    Each tenant's closures run on its own block of the lanes still
    stepping (:func:`_packed_transient_lanes`); the step controller, the
    per-lane kernels and the sync are shared. The Newton finish picks
    the lanes of every tenant with one sync, then finishes each tenant's
    on its own. A tenant with a non-finite endpoint records a
    ``transient:nonfinite`` degradation event (one more counted sync,
    the bundle's).

    ``conds`` is one value shared by every tenant or a sequence of one
    per tenant; the tenants must share a lane count (``ValueError``).
    One tenant runs its solo transient; a mechanism that fits no bucket
    sends every tenant to its solo transient (with a ``degradation``
    event); tenants of different buckets raise
    :class:`~..frontend.abi.AbiBucketError`. ``chunk`` is passed to the
    solo transients (:func:`batch_transient`); the pack takes the fused
    route. ``device=None`` runs on the CUDA
    card; pass ``"cpu"`` for the CPU."""
    specs = list(specs)
    k = len(specs)
    if k == 0:
        return []
    shared = not isinstance(conds, (list, tuple)) or isinstance(conds,
                                                                Conditions)
    conds_list = [conds] * k if shared else list(conds)
    if len(conds_list) != k:
        raise ValueError(f"conds: {len(conds_list)} entries for {k} "
                         f"tenants")

    def solo():
        return [batch_transient(s, c, save_ts, opts=opts, chunk=chunk,
                                abi=True, device=device)
                for s, c in zip(specs, conds_list)]

    if k == 1:
        return solo()
    lows = [s if isinstance(s, _abi.AbiLowered) else _abi.maybe_lower(s)
            for s in specs]
    if any(low is None for low in lows):
        record_event("degradation", label="packed:solo-fallback",
                     detail="a mechanism fits no ABI bucket; running "
                            "tenants as solo transients", tenants=k)
        _metrics.counter(
            "pycatkin_packed_solo_fallbacks_total",
            "packed sweep requests degraded to per-tenant solo "
            "sweeps").inc()
        return solo()
    pack = _abi.pack_lowered(lows)
    lanes = [len(np.asarray(c.T)) for c in conds_list]
    if len(set(lanes)) != 1:
        raise ValueError(f"packed tenants must share a lane count, got "
                         f"{lanes}")
    L = lanes[0]
    _metrics.counter(
        "pycatkin_packed_transient_sweeps_total",
        "packed multi-tenant transient dispatches per tenant "
        "sub-bucket").inc(bucket=pack.abi_fingerprint)
    bound = [_bind(low, low.pad_conditions(c), None, device)[:2]
             for low, c in zip(lows, conds_list)]

    def run_packed():
        tenant_lanes = [engine._transient_closures(
            ds, c, steady_rel=opts.steady_rel) for ds, c in bound]
        y0 = torch.cat([c.y0 for _, c in bound]).contiguous()
        ys, ok = ode.integrate(_packed_transient_lanes(tenant_lanes, L),
                               y0, save_ts, opts)
        ode.SYNCS["finish_lanes"] += 1
        not_ok = np.flatnonzero(~ok.cpu().numpy())
        cut = np.searchsorted(not_ok, np.arange(k + 1) * L)
        out = []
        for i, (ds, c) in enumerate(bound):
            ys_k = ys[i * L:(i + 1) * L]
            y_fin, ok_k = engine.transient_finish(
                ds, c, ys_k[:, -1], ok[i * L:(i + 1) * L],
                sopts=engine.finish_options(opts),
                idx=not_ok[cut[i]:cut[i + 1]] - i * L)
            ys_k[:, -1] = y_fin
            out.append((ys_k, ok_k))
        return out

    with span("packed transient sweep", tenants=pack.k,
              k_bucket=pack.k_bucket, lanes=L):
        out = call_with_backend_retry(run_packed,
                                      label="packed batched transient")
    nonfinite = torch.stack([
        torch.sum(~torch.all(torch.isfinite(ys[:, -1, :]), dim=-1))
        for ys, _ in out])
    ode.SYNCS["transient_bundle"] += 1
    n_quar = int(host_sync(nonfinite, "packed transient bundle").sum())
    if n_quar:
        record_event("degradation", label="transient:nonfinite",
                     detail="transient lanes with non-finite endpoints",
                     lanes=n_quar)
    return [(low.unpad_y(ys).clone(), ok) for low, (ys, ok) in zip(lows, out)]
