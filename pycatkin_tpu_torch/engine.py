"""The lane-batched engine (PyTorch port of ``pycatkin_tpu/engine.py``).

Composition of the kernel layers for a batch of conditions:

    free_energies      <- ops.thermo + scaling relations
    reaction_energies  <- stoichiometric sums
    rate_constants     <- ops.rates dispatch
    steady_state       <- solvers.newton (PTC or LM, random restarts; the
                          f32-polish precision tier's float32 closures)
    transient          <- solvers.ode (TR-BDF2 or ESDIRK4), then a Newton
                          finish by steady_state
    steady_jacobian    <- torch.func.jacfwd of the dynamic residual
    tof / activity     <- net rates of the selected steps
    drc / drc_fd       <- the implicit adjoint through the steady state
                          (a torch.autograd.Function), or central
                          differences over one batched steady solve

A host :class:`ModelSpec` is moved to the device once by :func:`bind`;
every function then takes that :class:`DeviceSpec` and a
:class:`Conditions` whose fields carry a leading lane dimension
``[L, ...]`` (see :func:`conditions_to`). No arithmetic crosses lanes.
"""

from __future__ import annotations

import copy
from typing import NamedTuple, Optional

import numpy as np
import torch

from . import precision
from .constants import LOG_H_OVER_KB, R, bartoPa, eVtokJ, kB
from .frontend.abi import AbiLowered
from .frontend.spec import REACTOR_CSTR, Conditions, ModelSpec
from .ops import linalg, network, rates, thermo
from .solvers import newton, ode
from .solvers.newton import SolverOptions, SteadyStateResults
from .solvers.ode import ODEOptions

eVtoJmol = eVtokJ * 1.0e3

_INDEX_FIELDS = ("scl_idx", "reac_idx", "prod_idx", "dynamic_indices",
                 "adsorbate_indices", "gas_indices")


class DeviceSpec:
    """A :class:`ModelSpec` on one device: every float array as a float64
    tensor, every index array as an int64 tensor, scalar and tuple
    fields as they are, the host spec as ``.host``; plus the derived
    tensors the solver needs (``dS_PR = SP - SR``, ``dS_TR = ST - SR``,
    ``groups_dyn``, ``dyn_src``). ``dyn_mask`` (``[n_dyn]``, optional)
    marks real dynamic slots; pad slots get the decoupled residual
    ``F = -x``. A spec lowered into an ABI bucket also carries its
    padded deflation basis ``lyap_q`` (``[D, 4]``) and its validity
    flag ``lyap_ok`` (a 0-d tensor, 1 or 0), and ``abi_fingerprint``, its
    bucket's fingerprint (:func:`bind` sets it); all three are None
    otherwise."""

    def __init__(self, spec: ModelSpec, device, dyn_mask=None,
                 lyap_q=None, lyap_ok=None):
        import dataclasses
        self.host = spec
        self.abi_fingerprint = None
        self.device = torch.device(device)
        for f in dataclasses.fields(spec):
            v = getattr(spec, f.name)
            if isinstance(v, np.ndarray):
                dt = torch.int64 if f.name in _INDEX_FIELDS else \
                    torch.float64
                v = torch.as_tensor(np.asarray(v), dtype=dt,
                                    device=self.device)
            setattr(self, f.name, v)
        t = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                      device=self.device)
        self.dS_PR = t(spec.SP - spec.SR)
        self.dS_TR = t(spec.ST - spec.SR)
        dyn = np.asarray(spec.dynamic_indices)
        self.dyn = self.dynamic_indices
        self.groups_dyn = t(np.asarray(spec.groups)[:, dyn])
        # y = cat([y_base, x])[dyn_src]: composes the full state from the
        # dynamic vector without an in-place scatter (vmap/jacfwd-safe).
        src = np.arange(spec.n_species)
        src[dyn] = spec.n_species + np.arange(dyn.size)
        self.dyn_src = torch.as_tensor(src, dtype=torch.int64,
                                       device=self.device)
        self.dyn_mask = None if dyn_mask is None else t(dyn_mask)
        self.lyap_q = None if lyap_q is None else t(lyap_q)
        self.lyap_ok = None if lyap_ok is None else t(lyap_ok)
        self.has_udar = spec.has_udar
        self.has_gfree = spec.has_gfree
        self.n_species = spec.n_species
        self.n_reactions = spec.n_reactions


def bind(spec, device, dyn_mask=None) -> DeviceSpec:
    """Move ``spec`` to ``device`` (see :class:`DeviceSpec`). An
    :class:`~.frontend.abi.AbiLowered` binds its padded spec with its
    ``dyn_mask``, ``lyap_q`` and ``lyap_ok``."""
    if isinstance(spec, AbiLowered):
        ds = DeviceSpec(spec.spec_padded, device, dyn_mask=spec.dyn_mask,
                        lyap_q=spec.lyap_q, lyap_ok=spec.lyap_ok)
        ds.abi_fingerprint = spec.abi_fingerprint
        return ds
    return DeviceSpec(spec, device, dyn_mask=dyn_mask)


def conditions_to(cond: Conditions, device) -> Conditions:
    """Every field of ``cond`` as a float64 tensor on ``device``."""
    return Conditions(*(torch.as_tensor(np.asarray(v, dtype=np.float64),
                                        dtype=torch.float64, device=device)
                        for v in cond))


class FreeEnergies(NamedTuple):
    gelec: torch.Tensor   # [L, n_s] electronic (scaling relations resolved)
    gfree: torch.Tensor   # [L, n_s] total free energy
    gvibr: torch.Tensor
    gtran: torch.Tensor
    grota: torch.Tensor


class ReactionEnergies(NamedTuple):
    dErxn: torch.Tensor   # [L, n_r] J/mol
    dGrxn: torch.Tensor
    dEa_fwd: torch.Tensor
    dGa_fwd: torch.Tensor
    dEa_rev: torch.Tensor
    dGa_rev: torch.Tensor


def free_energies(ds: DeviceSpec, cond: Conditions) -> FreeEnergies:
    """Electronic + free energies of every species at (T, p) [eV]."""
    gv, gt, gr = thermo.thermal_contributions(
        cond.T, cond.p,
        freq=ds.freq, fmask=ds.fmask, mass=ds.mass, sigma=ds.sigma,
        inertia=ds.inertia, is_gas=ds.is_gas, is_linear=ds.is_linear,
        mix=ds.mix,
        gvibr0=ds.gvibr0, gvibr_mask=ds.gvibr_mask,
        gtran0=ds.gtran0, gtran_mask=ds.gtran_mask,
        grota0=ds.grota0, grota_mask=ds.grota_mask)

    e_full = cond.gelec
    if ds.scl_idx.numel():
        # Linear scaling relations, solved as a small linear system so
        # scaling states may reference each other.
        b = ds.scl_b + e_full @ ds.scl_We.T + cond.uE_rxn @ ds.scl_WuE.T
        n_sc = ds.scl_idx.numel()
        A = torch.eye(n_sc, dtype=torch.float64, device=ds.device) - ds.scl_Ws
        A = A.expand(b.shape[:-1] + (n_sc, n_sc)).contiguous()
        e_scl = linalg.scaling_solve(A, b)
        e_full = e_full.index_copy(-1, ds.scl_idx, e_scl)

    mods = ds.add0 + cond.eps
    g0 = e_full + gv + gt + gr + mods
    if ds.has_udar:
        corr = (e_full @ ds.udar_Ce.T + g0 @ ds.udar_Cg.T
                + cond.uE_rxn @ ds.udar_CuE.T + cond.uG_rxn @ ds.udar_CuG.T)
        g = torch.where(ds.udar_mask > 0, e_full + corr + mods, g0)
    else:
        g = g0
    if ds.has_gfree:
        g = torch.where(ds.gfree_mask > 0, ds.gfree0 + mods, g)
    return FreeEnergies(gelec=e_full, gfree=g, gvibr=gv, gtran=gt, grota=gr)


def reaction_energies(ds: DeviceSpec, cond: Conditions,
                      fe: FreeEnergies | None = None) -> ReactionEnergies:
    """Reaction energies and barriers [J/mol]. User-defined reactions take
    their energies from the conditions; TS-less reactions have zero
    barriers."""
    if fe is None:
        fe = free_energies(ds, cond)
    e, g = fe.gelec, fe.gfree
    dE = e @ ds.dS_PR.T * eVtoJmol
    dG = g @ ds.dS_PR.T * eVtoJmol
    dE = torch.where(cond.u_rxn_mask > 0, cond.uE_rxn * eVtoJmol, dE)
    dG = torch.where(cond.u_rxn_mask > 0, cond.uG_rxn * eVtoJmol, dG)
    dEa_ts = e @ ds.dS_TR.T * eVtoJmol * ds.has_TS
    dGa_ts = g @ ds.dS_TR.T * eVtoJmol * ds.has_TS
    dEa = torch.where(ds.is_user > 0,
                      cond.uEa * eVtoJmol * cond.u_bar_mask, dEa_ts)
    dGa = torch.where(ds.is_user > 0,
                      cond.uGa * eVtoJmol * cond.u_bar_mask, dGa_ts)
    return ReactionEnergies(dErxn=dE, dGrxn=dG, dEa_fwd=dEa, dGa_fwd=dGa,
                            dEa_rev=dEa - dE, dGa_rev=dGa - dG)


def rate_constants(ds: DeviceSpec, cond: Conditions,
                   re: ReactionEnergies | None = None):
    """``(kf, kr, Keq)`` for every reaction, ``[L, n_r]`` each."""
    if re is None:
        re = reaction_energies(ds, cond)
    act = cond.is_activated
    return rates.rate_constants(
        cond.T,
        dGrxn=re.dGrxn, dErxn=re.dErxn, dGa_fwd=re.dGa_fwd,
        is_arr=act,
        is_ads=ds.is_ads * (1.0 - act),
        is_des=ds.is_des * (1.0 - act),
        is_ghost=ds.is_ghost,
        reversible=ds.reversible,
        area=ds.area, gas_mass=ds.gas_mass, gas_sigma=ds.gas_sigma,
        gas_inertia=ds.gas_inertia, gas_polyatomic=ds.gas_polyatomic,
        kscale=cond.kscale,
        collision_des=(ds.desorption_model == "collision"))


class Reactor(NamedTuple):
    """Per-lane reactor terms of :func:`network.reactor_rhs_and_scale`."""
    sigma_over_bar: torch.Tensor   # [L]
    inflow: torch.Tensor           # [L, n_s]


def reactor_terms(ds: DeviceSpec, cond: Conditions) -> Reactor:
    if ds.reactor_type == REACTOR_CSTR:
        sigma = kB * cond.T * ds.catalyst_area / ds.volume
        return Reactor(sigma / bartoPa, cond.inflow)
    return Reactor(torch.zeros_like(cond.T), cond.inflow)


def _static(ds: DeviceSpec) -> dict:
    return dict(reac_idx=ds.reac_idx, prod_idx=ds.prod_idx,
                is_gas=ds.is_gas, stoich=ds.stoich,
                is_adsorbate=ds.is_adsorbate, reactor_type=ds.reactor_type,
                inv_tau=(1.0 / ds.residence_time
                         if ds.reactor_type == REACTOR_CSTR else 0.0))


class FullState(NamedTuple):
    """Per-lane operands of the full-state reactor right-hand side."""
    kf: torch.Tensor               # [L, n_r]
    kr: torch.Tensor               # [L, n_r]
    sigma_over_bar: torch.Tensor   # [L]
    inflow: torch.Tensor           # [L, n_s]

    def lanes(self, idx) -> "FullState":
        return FullState(*(a[idx] for a in self))


def full_state_operands(ds: DeviceSpec, cond: Conditions, kf=None,
                        kr=None) -> FullState:
    """The :class:`FullState` of every lane (rate constants computed
    unless given)."""
    if kf is None:
        kf, kr, _ = rate_constants(ds, cond)
    rt = reactor_terms(ds, cond)
    return FullState(kf, kr, rt.sigma_over_bar, rt.inflow)


def _full_rhs(ds: DeviceSpec, ops: FullState, y, with_gross: bool):
    kw = dict(sigma_over_bar=ops.sigma_over_bar, inflow=ops.inflow,
              **_static(ds))
    if with_gross:
        return network.reactor_rhs_and_scale(y, ops.kf, ops.kr, **kw)
    return network.reactor_rhs(y, ops.kf, ops.kr, **kw)


def full_jacobian(ds: DeviceSpec, ops: FullState, y):
    """``[L, n_s, n_s]`` Jacobian of the full-state right-hand side:
    ``torch.func.jacfwd`` of the per-lane right-hand side under
    ``torch.func.vmap`` over lanes."""
    st = _static(ds)

    def rhs_one(y1, kf1, kr1, sob1, inf1):
        return network.reactor_rhs(y1, kf1, kr1, sigma_over_bar=sob1,
                                   inflow=inf1, **st)
    return torch.func.vmap(torch.func.jacfwd(rhs_one))(y, *ops)


def make_rhs_and_scale(ds: DeviceSpec, cond: Conditions, kf=None, kr=None):
    """``(rhs, rhs_and_scale)``: lane-batched closures ``y [L, n_s] ->
    dy/dt`` and ``-> (dy/dt, gross)`` over one set of reactor operands,
    so the steadiness oracles see exactly the model being integrated."""
    ops = full_state_operands(ds, cond, kf, kr)
    return (lambda y: _full_rhs(ds, ops, y, False),
            lambda y: _full_rhs(ds, ops, y, True))


def make_rhs(ds: DeviceSpec, cond: Conditions, kf=None, kr=None):
    """The reactor ODE right-hand side ``y [L, n_s] -> dy/dt``."""
    return make_rhs_and_scale(ds, cond, kf, kr)[0]


def get_dydt(ds: DeviceSpec, cond: Conditions, y):
    """dy/dt of the full solution vectors ``y [L, n_s]``."""
    return make_rhs(ds, cond)(y)


def get_jacobian(ds: DeviceSpec, cond: Conditions, y):
    """d(dy/dt)/dy at the full states ``y [L, n_s]``, ``[L, n_s, n_s]``
    (forward autodiff)."""
    return full_jacobian(ds, full_state_operands(ds, cond), y)


def reaction_rates_at(ds: DeviceSpec, cond: Conditions, y, kf=None,
                      kr=None):
    """Per-reaction forward and reverse rates ``([L, n_r], [L, n_r])`` at
    the compositions ``y [L, n_s]``."""
    if kf is None:
        kf, kr, _ = rate_constants(ds, cond)
    fwd, rev, _ = network.net_rates(y, kf, kr, reac_idx=ds.reac_idx,
                                    prod_idx=ds.prod_idx, is_gas=ds.is_gas)
    return fwd, rev


def compose_state(ds: DeviceSpec, y_base, x):
    """The full state: ``y_base`` with its dynamic entries set to ``x``."""
    return torch.cat([y_base, x], dim=-1)[..., ds.dyn_src]


def dynamic_fscale(ds: DeviceSpec, x, kf, kr, y_base, sigma_over_bar,
                   inflow):
    """``(F, gross)`` over the dynamic indices at the dynamic vector
    ``x``: the residual plus the per-species gross-flux scale. Works for
    any leading lane shape (the batched solver and the per-lane function
    that ``jacfwd`` differentiates share it). Pad slots of
    ``ds.dyn_mask`` get ``F = -x`` and ``gross = 1``."""
    y = compose_state(ds, y_base, x)
    F, gross = network.reactor_rhs_and_scale(
        y, kf, kr, sigma_over_bar=sigma_over_bar, inflow=inflow,
        **_static(ds))
    F, gross = F[..., ds.dyn], gross[..., ds.dyn]
    if ds.dyn_mask is not None:
        F = torch.where(ds.dyn_mask > 0, F, -x)
        gross = torch.where(ds.dyn_mask > 0, gross, torch.ones_like(gross))
    return F, gross


def residual_jacobian(ds: DeviceSpec, x, kf, kr, y_base, sigma_over_bar,
                      inflow):
    """``[L, n_dyn, n_dyn]`` Jacobian of the dynamic residual:
    ``torch.func.jacfwd`` of the per-lane residual under
    ``torch.func.vmap`` over lanes."""
    def residual_one(x1, kf1, kr1, yb1, sob1, inf1):
        return dynamic_fscale(ds, x1, kf1, kr1, yb1, sob1, inf1)[0]
    return torch.func.vmap(torch.func.jacfwd(residual_one))(
        x, kf, kr, y_base, sigma_over_bar, inflow)


class Closures(NamedTuple):
    """The batched residual-and-scale and Jacobian of one lane batch."""
    fscale: object
    jac: object
    y_base: torch.Tensor


def _cast_view(ds: DeviceSpec, dtype) -> DeviceSpec:
    """A shallow copy of ``ds`` with every floating tensor in ``dtype``
    (the JAX package's ``_cast_float_leaves``)."""
    view = copy.copy(ds)
    for name, v in vars(ds).items():
        if torch.is_tensor(v) and v.is_floating_point():
            setattr(view, name, v.to(dtype))
    return view


def closures(ds: DeviceSpec, cond: Conditions, kf, kr,
             dtype=None) -> Closures:
    """The closures of the lane batch ``cond`` over the rate constants
    ``kf``, ``kr``. ``dtype`` (None: float64) evaluates them in another
    type: the rate constants and reactor terms are computed in float64
    (``exp(-Ea/kT)`` spans ~30 decades) and only the finished values,
    with the spec's stoichiometry and masks, are cast down, as the JAX
    package's ``_dynamic_fscale(dtype=...)`` does."""
    rt = reactor_terms(ds, cond)
    args = (kf, kr, cond.y0, rt.sigma_over_bar, rt.inflow)
    if dtype is not None:
        ds = _cast_view(ds, dtype)
        args = tuple(a.to(dtype) for a in args)
    return Closures(
        fscale=lambda x: dynamic_fscale(ds, x, *args),
        jac=lambda x: residual_jacobian(ds, x, *args),
        y_base=args[2])


def bulk_closures(ds: DeviceSpec, cond: Conditions, kf, kr, tier: str):
    """``(fscale, jac)`` at the bulk dtype of the precision ``tier`` over
    the same rate constants (:func:`closures`), or None under
    ``"f64"``."""
    if precision.check_tier(tier) == "f64":
        return None
    b = closures(ds, cond, kf, kr, dtype=precision.bulk_dtype(tier))
    return b.fscale, b.jac


def lane_subset(cond: Conditions, idx) -> Conditions:
    """The lanes ``idx`` (a long tensor or array) of ``cond``."""
    idx = torch.as_tensor(idx, device=cond.T.device)
    return Conditions(*(f[idx] for f in cond))


def steady_state(ds: DeviceSpec, cond: Conditions, x0=None, key=None,
                 opts: SolverOptions = SolverOptions(),
                 strategy: str = "ptc",
                 tier: str = "f64") -> SteadyStateResults:
    """Steady-state solve of every lane over the dynamic indices (gas
    clamped for the infinite-dilution reactor) by
    :func:`newton.solve_steady`.

    ``x0 [L, n_dyn]`` defaults to the dynamic entries of ``cond.y0``.
    ``key [L, 2]`` holds each lane's PRNG key for the random restarts
    of a multi-attempt solve (None: ``prng_key(0)`` for every lane);
    ``strategy`` is ``"ptc"`` or ``"lm"``. Each attempt after the first
    runs only the lanes still failing. ``tier``: the precision tier
    (:mod:`.precision`); under ``"f32-polish"`` a single-attempt solve
    marches on a second pair of closures at float32
    (:func:`bulk_closures`) and polishes and judges in float64, while a
    multi-attempt solve stays float64 (its ``lanes(idx)`` closures
    are)."""
    kf, kr, _ = rate_constants(ds, cond)
    cl = closures(ds, cond, kf, kr)
    bulk = bulk_closures(ds, cond, kf, kr, tier)
    if x0 is None:
        x0 = cl.y_base[..., ds.dyn]

    def lanes(idx):
        sub = closures(ds, lane_subset(cond, idx), kf[idx], kr[idx])
        return sub.fscale, sub.jac

    (x, success, res, iters, attempts, rate_ok, pos_ok, sums_ok,
     dt_exit, chords) = newton.solve_steady(
        cl.fscale, cl.jac, x0.contiguous(), ds.groups_dyn, opts, key=key,
        strategy=strategy, lanes=lanes, tier=tier, bulk_fns=bulk)
    return SteadyStateResults(
        x=compose_state(ds, cl.y_base, x), success=success, residual=res,
        iterations=iters, attempts=attempts, rate_ok=rate_ok,
        pos_ok=pos_ok, sums_ok=sums_ok, dt_exit=dt_exit, chords=chords)


def steady_jacobian(ds: DeviceSpec, cond: Conditions, x_dyn):
    """Jacobian of the dynamic residual at ``x_dyn`` ``[L, n_dyn]``."""
    kf, kr, _ = rate_constants(ds, cond)
    return closures(ds, cond, kf, kr).jac(x_dyn)


def check_stability(ds: DeviceSpec, cond: Conditions, y_full,
                    pos_tol: float = 1e-2) -> np.ndarray:
    """Jacobian-eigenvalue stability verdict of every lane at its full
    state ``y_full [L, n_s]``: each eigenvalue's real part at most the
    scale-aware tolerance (:func:`newton.stability_tolerance`). The
    Jacobians are formed on the device, the eigenvalues on the host
    (numpy); returns a numpy bool array ``[L]``."""
    J = steady_jacobian(ds, cond, torch.as_tensor(y_full)[..., ds.dyn])
    return newton.jacobian_eigenvalues_stable(J.cpu().numpy(), pos_tol)


def _transient_closures(ds: DeviceSpec, cond: Conditions,
                        steady_rel: float = ODEOptions().steady_rel,
                        kf=None, kr=None):
    """``lanes(idx) -> ode.OdeFns``: the integrator's closures over the
    lanes ``idx`` (host int64 indices; None: all lanes), with two
    oracles on the net and gross fluxes of each lane. ``steady``
    (freeze): ``|net| <= 8 eps gross`` everywhere, the f64 cancellation
    floor of the flux sums, no absolute term (a metastable plateau has
    tiny ``|net|``).
    ``relaxed`` (accelerate): ``|net| <= steady_rel gross`` everywhere,
    the steady verdict's tolerance, which waives the noise-dominated
    local-error test while the state keeps evolving."""
    ops = full_state_operands(ds, cond, kf, kr)
    floor = 8.0 * float(torch.finfo(torch.float64).eps)

    def lanes(idx=None):
        o = ops if idx is None else ops.lanes(
            torch.as_tensor(idx, device=ops.kf.device))

        def oracles(y):
            net, gross = _full_rhs(ds, o, y, True)
            a = torch.abs(net)
            return (net, torch.all(a <= floor * gross, dim=-1),
                    torch.all(a <= steady_rel * gross, dim=-1))
        return ode.OdeFns(f=lambda y: _full_rhs(ds, o, y, False),
                          jac=lambda y: full_jacobian(ds, o, y),
                          oracles=oracles)
    return lanes


def transient_state(ds: DeviceSpec, cond: Conditions, state, save_ts,
                    opts: ODEOptions = ODEOptions()):
    """Advance a transient carry (``ode.init_state``) of every lane
    through the save times ``save_ts``. Returns ``(state, ys)``."""
    lanes = _transient_closures(ds, cond, steady_rel=opts.steady_rel)
    return ode.integrate_state(lanes, state, save_ts, opts)


def transient_finish(ds: DeviceSpec, cond: Conditions, y_last, ok,
                     sopts: SolverOptions = SolverOptions(), idx=None):
    """Newton finish of the lanes that did not reach the end of the
    grid: where relaxed stepping ran out of ``max_steps`` but the state
    already satisfies the steady verdict, land on the attractor with the
    multi-attempt steady solve from ``y_last`` (key ``prng_key(0)`` on
    every lane), and keep it only if it converged within 5e-2 of
    ``y_last`` in every entry (a different root keeps the failure
    flag). Returns ``(y_final, ok)``.

    The JAX package runs the solve on every lane and keeps it where
    ``~ok & good``, then returns ``ok | good``; neither touches a lane
    that is ``ok``, so only the other lanes are solved here (picking
    them is one counted sync, unless the caller passes them as ``idx``,
    host indices of the lanes that are not ``ok``)."""
    if idx is None:
        ode.SYNCS["finish_lanes"] += 1
        idx = np.flatnonzero(~ok.cpu().numpy())
    if idx.size == 0:
        return y_last, ok
    sel = torch.as_tensor(idx, device=y_last.device)
    y_sel = y_last[sel]
    sub = lane_subset(cond, sel)
    res = steady_state(ds, sub, x0=y_sel[:, ds.dyn], opts=sopts)
    _, _, relaxed = _transient_closures(
        ds, sub, steady_rel=sopts.rate_tol_rel)(None).oracles(y_sel)
    near = torch.amax(torch.abs(res.x - y_sel), dim=-1) <= 5.0e-2
    good = res.success & relaxed & near
    ode.FINISH["lanes"] += int(idx.size)
    ode.FINISH["rescued"] = good.sum() + torch.as_tensor(
        ode.FINISH["rescued"]).to(good.device)
    return (y_last.index_copy(0, sel, torch.where(good[:, None], res.x,
                                                  y_sel)),
            ok.index_copy(0, sel, good))


def finish_options(opts: ODEOptions) -> SolverOptions:
    """The Newton finish's options: the verdict judged at the
    integration's own ``steady_rel``."""
    return SolverOptions(rate_tol_rel=opts.steady_rel)


def transient(ds: DeviceSpec, cond: Conditions, save_ts,
              opts: ODEOptions = ODEOptions()):
    """Integrate every lane's reactor ODEs from ``cond.y0`` over the save
    times ``save_ts`` (``save_ts[0]`` the initial time), then the Newton
    finish (:func:`transient_finish`) of the last point. Returns ``(ys
    [L, len(save_ts), n_s], ok [L])``."""
    lanes = _transient_closures(ds, cond, steady_rel=opts.steady_rel)
    ys, ok = ode.integrate(lanes, cond.y0.contiguous(), save_ts, opts)
    y_fin, ok = transient_finish(ds, cond, ys[:, -1], ok,
                                 sopts=finish_options(opts))
    ys[:, -1] = y_fin
    return ys, ok


def _transient_materialized(n: int) -> None:
    """Count blocking transient save-buffer pulls to the host
    (``pycatkin_transient_materializations_total``): the chunked drive
    pays one a chunk plus the finish."""
    from .obs import metrics as _metrics
    _metrics.counter(
        "pycatkin_transient_materializations_total",
        "blocking transient save-buffer materializations").inc(n)


def chunked_transient_drive(step, finish, conds, y0, save_ts,
                            opts: ODEOptions, chunk: int, batched: bool,
                            force_chunking: bool = False):
    """The host-driven chunking protocol of the save grid: the times
    after ``save_ts[0]`` in blocks of ``chunk`` (the last block padded
    with repeats of the final time, which are no-ops), each block one
    bounded call ``step(conds, state, part) -> (state, ys_block)`` from
    the carry ``state = ode.init_state(y0, save_ts[0], opts)`` whose
    states are pulled to the host (one counted ``host_sync`` a block),
    then ``finish(conds, y_last, ok) -> (y_final, ok)`` on the endpoint.
    ``batched``: whether ``y0`` carries a leading lane axis. As in the
    JAX package, off a TPU -- the card is not one -- the grid runs as
    one block unless ``force_chunking``. Returns ``(ys, ok)`` on ``y0``'s
    device, bit for bit :func:`transient`'s on the same closures."""
    from .utils.profiling import host_sync
    save_ts = np.asarray(save_ts, dtype=np.float64).ravel()
    if not force_chunking:
        chunk = max(chunk, len(save_ts))
    y0 = y0 if batched else y0[None]
    state = ode.init_state(y0, save_ts[0], opts)
    blocks = [host_sync(y0, "transient y0")[:, None, :]]
    ts = save_ts[1:]
    for i in range(0, len(ts), chunk):
        part = ts[i:i + chunk]
        npad = chunk - len(part)
        if npad:
            part = np.concatenate([part, np.full(npad, ts[-1])])
        state, ys_chunk = step(conds, state, part)
        ys_np = host_sync(ys_chunk, f"transient chunk[{i // chunk}]")
        _transient_materialized(1)
        blocks.append(ys_np[:, :chunk - npad] if npad else ys_np)
    ys = np.concatenate(blocks, axis=1)
    y_fin, ok = finish(conds, torch.as_tensor(ys[:, -1], device=y0.device),
                       state[3])
    ys[:, -1] = host_sync(y_fin, "transient finish")
    _transient_materialized(1)
    ys = torch.as_tensor(ys, device=y0.device)
    return (ys, ok) if batched else (ys[0], ok[0])


def transient_chunked(ds: DeviceSpec, cond: Conditions, save_ts,
                      opts: ODEOptions = ODEOptions(), chunk: int = 16,
                      force_chunking: bool = False):
    """The host-driven transient of every lane (see
    :func:`chunked_transient_drive`): the integration and the Newton
    finish of :func:`transient`, bit for bit. Returns ``(ys [L, t, n_s],
    ok [L])``; the JAX package's single-lane form is a batch of one."""
    return chunked_transient_drive(
        lambda c, st, part: transient_state(ds, c, st, part, opts),
        lambda c, y, ok: transient_finish(ds, c, y, ok,
                                          sopts=finish_options(opts)),
        cond, cond.y0.contiguous(), save_ts, opts, chunk, batched=True,
        force_chunking=force_chunking)


def tof(ds: DeviceSpec, cond: Conditions, y, tof_mask):
    """Turnover frequency per lane: the summed net rates of the steps
    selected by ``tof_mask`` ``[n_r]`` at the full state ``y``."""
    kf, kr, _ = rate_constants(ds, cond)
    net = network.net_rates(y, kf, kr, reac_idx=ds.reac_idx,
                            prod_idx=ds.prod_idx, is_gas=ds.is_gas)[2]
    return torch.sum(tof_mask * net, dim=-1)


def activity_from_tof(tof_value, T):
    """Activity [eV] = ln(h*|TOF|/kB*T) * RT, assembled in log space; a
    negative TOF enters by magnitude (the sweep flags its sign), an
    exactly-zero TOF gives -inf."""
    log_term = torch.log(torch.abs(tof_value)) + LOG_H_OVER_KB \
        - torch.log(T)
    return (log_term * (R * T)) * 1.0e-3 / eVtokJ


def tof_mask_for(spec: ModelSpec, tof_terms) -> np.ndarray:
    mask = np.zeros(spec.n_reactions)
    for t in tof_terms:
        mask[spec.rindex(t)] = 1.0
    return mask


def closed_form_jacobian(ds: DeviceSpec, cond: Conditions, x_dyn,
                         kf: Optional[torch.Tensor] = None,
                         kr: Optional[torch.Tensor] = None):
    """The dynamic Jacobian from the closed-form reactor Jacobian
    (:func:`network.reactor_jacobian`) restricted to the dynamic block --
    the independent oracle that :func:`steady_jacobian` is tested
    against."""
    if kf is None:
        kf, kr, _ = rate_constants(ds, cond)
    rt = reactor_terms(ds, cond)
    y = compose_state(ds, cond.y0, x_dyn)
    J = network.reactor_jacobian(y, kf, kr,
                                 sigma_over_bar=rt.sigma_over_bar,
                                 inflow=rt.inflow, **_static(ds))
    return J[..., ds.dyn, :][..., ds.dyn]


# ----------------------------------------------------------------------
# implicit differentiation through the steady state
def _residual(ds: DeviceSpec, cond: Conditions, x):
    """The dynamic residual ``F [L, n_dyn]`` at ``x``, as a function of
    every float field of ``cond`` (autograd follows all of them)."""
    kf, kr, _ = rate_constants(ds, cond)
    return closures(ds, cond, kf, kr).fscale(x)[0]


def _constrained(ds: DeviceSpec, J):
    """``(B, M)``: the residual's Jacobian ``J`` with one row per
    conservation group replaced by the group row, and the mask ``M`` of
    the replaced rows (``newton.conservation_constraints``)."""
    R, M = newton.conservation_constraints(ds.groups_dyn)
    return torch.where(M[:, None] > 0, R, J), M


def _polish(ds: DeviceSpec, cond: Conditions, x):
    """Two constrained-Newton steps at the solution ``x [L, n_dyn]``. The
    PTC solve stops at its residual tolerance, which bounds the error
    along stiff directions only; the implicit function theorem holds at
    the root, and full Newton on the conservation-constrained system
    pins the soft modes too. Each lane keeps a step only if its own
    max |F| does not grow."""
    kf, kr, _ = rate_constants(ds, cond)
    cl = closures(ds, cond, kf, kr)
    F = cl.fscale(x)[0]
    for _ in range(2):
        B, M = _constrained(ds, cl.jac(x))
        x_new = x - linalg.solve(B, F * (1.0 - M))
        F_new = cl.fscale(x_new)[0]
        better = (torch.amax(torch.abs(F_new), dim=-1)
                  <= torch.amax(torch.abs(F), dim=-1))[:, None]
        x = torch.where(better, x_new, x)
        F = torch.where(better, F_new, F)
    return x


class _SteadyX(torch.autograd.Function):
    """``x*(cond)``, the polished steady state's dynamic entries, with
    the implicit-function-theorem adjoint as its backward: at F(x*, c) =
    0, ``dx*/dc = -B^-1 Z dF/dc``, with ``B`` the Jacobian whose one row
    per conservation group is the group row (so ``G x* = const`` holds
    too) and ``Z`` zeroing those rows' entries. One transposed solve per
    lane, then one vector-Jacobian product of the residual with respect
    to every field of the conditions that requires grad."""

    @staticmethod
    def forward(ctx, ds, solve, *fields):
        x = solve(Conditions(*fields))
        ctx.ds = ds
        ctx.save_for_backward(x, *fields)
        return x

    @staticmethod
    def backward(ctx, xbar):
        ds = ctx.ds
        x, *fields = ctx.saved_tensors
        want = ctx.needs_input_grad[2:]
        B, M = _constrained(ds, steady_jacobian(ds, Conditions(*fields), x))
        w = linalg.solve(B.mT.contiguous(), xbar.contiguous()) * (1.0 - M)
        with torch.enable_grad():
            leaves = [f.detach().requires_grad_(bool(n))
                      for f, n in zip(fields, want)]
            F = _residual(ds, Conditions(*leaves), x)
            grads = iter(torch.autograd.grad(
                F, [t for t, n in zip(leaves, want) if n], grad_outputs=-w,
                allow_unused=True))
        return (None, None) + tuple(next(grads) if n else None
                                    for n in want)


def make_steady_x(ds: DeviceSpec, opts: SolverOptions = SolverOptions(),
                  x0=None, key=None):
    """``f(cond) -> x* [L, n_dyn]``, differentiable by the implicit
    function theorem (:class:`_SteadyX`): the forward pass is
    :func:`steady_state` from ``x0`` with ``key``, then :func:`_polish`,
    without grad; the backward pass is one adjoint solve per lane
    (``linalg.solve``, routed as every solve of the port) instead of
    2 n_r perturbed re-solves."""

    def solve(cond):
        res = steady_state(ds, cond, x0=x0, key=key, opts=opts)
        return _polish(ds, cond, res.x[..., ds.dyn])
    return lambda cond: _SteadyX.apply(ds, solve, *cond)


def drc(ds: DeviceSpec, cond: Conditions, tof_terms,
        opts: SolverOptions = SolverOptions(), x0=None, key=None):
    """Degrees of rate control ``xi [L, n_r]``, ``xi_r = d ln TOF / d ln
    k_r`` with kf and kr scaled together (Keq kept), in reaction order:
    the gradient of ``sum_lanes ln TOF`` with respect to ``kscale``
    through :func:`make_steady_x`. Lanes are independent, so each row is
    its lane's own gradient; a lane whose TOF is NaN gives NaN, and one
    whose TOF is negative gives ``d ln|TOF|``, as ``jax.grad`` of
    ``jnp.log`` does."""
    mask = torch.as_tensor(tof_mask_for(ds.host, tof_terms),
                           dtype=torch.float64, device=ds.device)
    xstar = make_steady_x(ds, opts, x0=x0, key=key)
    kscale = cond.kscale.detach().clone().requires_grad_(True)
    with torch.enable_grad():
        c = cond._replace(kscale=kscale)
        y = compose_state(ds, c.y0, xstar(c))
        ln_tof = torch.log(tof(ds, c, y, mask))
        (xi,) = torch.autograd.grad(ln_tof.sum(), kscale)
    return xi


def drc_fd(ds: DeviceSpec, cond: Conditions, tof_terms, eps: float = 1e-3,
           opts: SolverOptions | None = None, x0=None, key=None):
    """Finite-difference degrees of rate control: central differences
    with kf and kr scaled by ``1 +/- eps``. Each lane expands into its
    ``2 n_r + 1`` scaled copies (base, up, down) and all ``L (2 n_r +
    1)`` solves run as one :func:`steady_state` call. Returns ``(xi [L,
    n_r], ok [L])``: ``ok`` is False where any of the lane's solves did
    not converge (its quotient may mix branches).

    Without ``opts`` the solves are tightened far below the default
    steady tolerance (``rate_tol=1e-14, rate_tol_rel=1e-13,
    max_steps=400``): an O(eps) rate change moves the residual by
    O(eps flux), which a solve already within the default tolerance at
    ``x0`` would not follow."""
    if opts is None:
        opts = SolverOptions(rate_tol=1e-14, rate_tol_rel=1e-13,
                             max_steps=400)
    mask = torch.as_tensor(tof_mask_for(ds.host, tof_terms),
                           dtype=torch.float64, device=ds.device)
    n_r = ds.n_reactions
    m = 2 * n_r + 1
    L = cond.kscale.shape[0]
    eye = torch.eye(n_r, dtype=torch.float64, device=ds.device)
    base = cond.kscale[:, None, :]
    scales = torch.cat([base, base * (1.0 + eps * eye),
                        base * (1.0 - eps * eye)], dim=1)
    rep = lambda t: None if t is None else t.repeat_interleave(m, dim=0)
    c = Conditions(*(rep(f) for f in cond))._replace(
        kscale=scales.reshape(L * m, n_r))
    res = steady_state(ds, c, x0=rep(x0), key=rep(key), opts=opts)
    tofs = tof(ds, c, res.x, mask).reshape(L, m)
    t0, tp, tm = tofs[:, :1], tofs[:, 1:1 + n_r], tofs[:, 1 + n_r:]
    return ((tp - tm) / (2.0 * eps * t0),
            torch.all(res.success.reshape(L, m), dim=1))
