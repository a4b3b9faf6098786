"""ModelSpec: compile the host object graph into static arrays (numpy only).

Port of ``pycatkin_tpu/frontend/spec.py``: the whole mechanism compiles
ONCE into an immutable bundle of padded numpy arrays (the *spec*) plus a
runtime :class:`Conditions` bundle. Everything that can vary between
solves -- temperature, pressure, descriptor/user energies, energy noise,
rate multipliers, initial and inflow compositions -- lives in
``Conditions``, so a sweep is a leading lane dimension on its fields.

Species ordering is the alphabetical order of state names; gas solution
entries are in bar. :func:`spec_from_arrays` / :func:`conditions_from_arrays`
carry a spec built elsewhere (a dict of its fields) into this package.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np

from .reactions import (ADSORPTION, ARRHENIUS, DESORPTION, GHOST, Reaction,
                        UserDefinedReaction)
from .states import ADSORBATE, GAS, SURFACE, ScalingState, State

# Reactor type codes (the same values as ``ops/network.py`` of the JAX
# package, which owns them there).
REACTOR_ID = 0
REACTOR_CSTR = 1


class Conditions(NamedTuple):
    """Runtime inputs to the engine. Each field is a scalar/array for one
    condition, or carries a leading lane dimension for a batch of them.

    Energies in eV; T in K; p in Pa; y0/inflow in legacy solution units
    (gas: bar, coverages: fraction).
    """
    T: object
    p: object
    gelec: object        # [n_s] electronic energies (plain states)
    eps: object          # [n_s] additive free-energy modifier (UQ noise etc.)
    uE_rxn: object       # [n_r] user electronic reaction energies
    uG_rxn: object       # [n_r] user free reaction energies
    uEa: object          # [n_r] user electronic barriers
    uGa: object          # [n_r] user free barriers
    u_rxn_mask: object   # [n_r] 1 where user reaction energies apply
    u_bar_mask: object   # [n_r] 1 where user barriers apply
    is_activated: object  # [n_r] 1 -> Arrhenius/activated rate expression
    kscale: object       # [n_r] multiplier on kf and kr (DRC channel)
    y0: object           # [n_s] initial / clamped-boundary composition
    inflow: object       # [n_s] CSTR inflow composition (bar)


@dataclass(frozen=True, eq=False)
class ModelSpec:
    """Immutable compiled mechanism. All arrays are numpy (static data,
    moved to the device once per sweep by :func:`engine.bind`).

    ``eq=False``: identity hashing/equality (field-wise dataclass
    equality would compare ndarrays)."""

    # --- species ---
    snames: tuple
    state_types: tuple
    freq: np.ndarray          # [n_s, F] Hz, descending, zero-padded
    fmask: np.ndarray         # [n_s, F] modes entering vibrational sums
    mass: np.ndarray          # [n_s]
    sigma: np.ndarray         # [n_s]
    inertia: np.ndarray       # [n_s, 3]
    is_gas: np.ndarray        # [n_s]
    is_linear: np.ndarray     # [n_s]
    mix: np.ndarray           # [n_s, n_s] gasdata fraction weights
    gelec0: np.ndarray        # [n_s] default electronic energies
    add0: np.ndarray          # [n_s] baseline add_to_energy
    gvibr0: np.ndarray
    gvibr_mask: np.ndarray
    gtran0: np.ndarray
    gtran_mask: np.ndarray
    grota0: np.ndarray
    grota_mask: np.ndarray
    gfree0: np.ndarray
    gfree_mask: np.ndarray

    # --- scaling relations (electronic) ---
    # e_full = e_plain + scl_onehot^T @ (b + We @ e_plain + Ws @ e_scl + WuE @ uE)
    scl_idx: np.ndarray       # [n_sc] species index of each scaling state
    scl_b: np.ndarray         # [n_sc]
    scl_We: np.ndarray        # [n_sc, n_s]
    scl_Ws: np.ndarray        # [n_sc, n_sc]
    scl_WuE: np.ndarray       # [n_sc, n_r]

    # --- use_descriptor_as_reactant free-energy correction ---
    udar_mask: np.ndarray     # [n_s]
    udar_Ce: np.ndarray       # [n_s, n_s] applied to e_full
    udar_Cg: np.ndarray       # [n_s, n_s] applied to base free energies
    udar_CuE: np.ndarray      # [n_s, n_r]
    udar_CuG: np.ndarray      # [n_s, n_r]

    # --- reactions ---
    rnames: tuple
    reac_types: tuple
    SR: np.ndarray            # [n_r, n_s] reactant counts (energy states)
    SP: np.ndarray            # [n_r, n_s] product counts (energy states)
    ST: np.ndarray            # [n_r, n_s] TS counts (energy states)
    has_TS: np.ndarray        # [n_r]
    reversible: np.ndarray    # [n_r]
    base_reversible: np.ndarray  # [n_r] reversibility of energy-source rxn
    is_arr_type: np.ndarray   # [n_r] declared Arrhenius type
    is_ads: np.ndarray        # [n_r]
    is_des: np.ndarray        # [n_r]
    is_ghost: np.ndarray      # [n_r]
    is_user: np.ndarray       # [n_r] UserDefinedReaction (energies from cond)
    area: np.ndarray          # [n_r]
    rscaling: np.ndarray      # [n_r]
    site_density: np.ndarray  # [n_r]
    gas_mass: np.ndarray      # [n_r]
    gas_sigma: np.ndarray     # [n_r]
    gas_inertia: np.ndarray   # [n_r, 3]
    gas_polyatomic: np.ndarray  # [n_r]
    reac_idx: np.ndarray      # [n_r, A] padded with n_s
    prod_idx: np.ndarray      # [n_r, A]
    stoich: np.ndarray        # [n_s, n_r] weighted stoichiometric matrix

    # --- reactor / conservation ---
    reactor_type: int
    volume: Optional[float]
    catalyst_area: Optional[float]
    residence_time: Optional[float]
    is_adsorbate: np.ndarray  # [n_s] appears in reactions as ads/surface
    is_gas_dyn: np.ndarray    # [n_s] appears in reactions as gas
    dynamic_indices: np.ndarray
    adsorbate_indices: np.ndarray
    gas_indices: np.ndarray
    groups: np.ndarray        # [n_g, n_s] site-conservation groups
    # 'detailed_balance' (upstream convention, golden-number compatible) or
    # 'collision' (the fork's kdes rotational-partition-function model).
    desorption_model: str = "detailed_balance"

    @property
    def n_species(self) -> int:
        return len(self.snames)

    @property
    def n_reactions(self) -> int:
        return len(self.rnames)

    @property
    def has_udar(self) -> bool:
        # Static use_descriptor_as_reactant gate; the ABI's TracedSpec
        # overrides this with an always-True class attribute (its padded
        # correction matrices make the block an exact no-op).
        return bool(np.asarray(self.udar_mask).any())

    @property
    def has_gfree(self) -> bool:
        return bool(np.asarray(self.gfree_mask).any())

    def sindex(self, name: str) -> int:
        return self.snames.index(name)

    def rindex(self, name: str) -> int:
        return self.rnames.index(name)


def _species_counts(states: list, oindex, n_s: int) -> np.ndarray:
    row = np.zeros(n_s)
    for s in states:
        row[oindex(s)] += 1.0
    return row


def build_spec(states: dict, reactions: dict, reactor=None,
               reactor_params: dict | None = None,
               desorption_model: str = "detailed_balance") -> ModelSpec:
    """Compile states + reactions (+ reactor) into a :class:`ModelSpec`.

    ``states``: name -> State (all loaded or loadable); ``reactions``:
    name -> Reaction, insertion-ordered. ``reactor``: REACTOR_ID /
    REACTOR_CSTR code; ``reactor_params``: volume/catalyst_area/
    residence_time for CSTR.
    """
    # Foreign energy-states: ReactionDerivedReaction bases may live in a
    # different system (reference reaction.py:312-334 computes their
    # energetics from that donor system's State objects). They join the
    # spec as energy-only species: thermo rows, no dynamics, no
    # conservation groups. Name collisions with system states get a
    # '@base' suffix so both energy sources stay distinct.
    all_states = dict(states)
    id2name = {id(st): n for n, st in states.items()}
    for rx in reactions.values():
        es = rx.energy_states
        for s in list(es.reactants) + list(es.products) + list(es.TS or []):
            if id(s) in id2name:
                continue
            name = s.name
            k = 1
            while name in all_states:
                name = f"{s.name}@base{k}"
                k += 1
            if s.is_scaling:
                raise NotImplementedError(
                    f"foreign scaling state {s.name} referenced by "
                    f"reaction {rx.name}: scaling relations must resolve "
                    "within one system")
            all_states[name] = s
            id2name[id(s)] = name

    snames = tuple(sorted(states.keys()) +
                   sorted(n for n in all_states if n not in states))
    n_s = len(snames)
    sindex = {n: i for i, n in enumerate(snames)}

    def oindex(st):
        return sindex[id2name[id(st)]]

    rnames = tuple(reactions.keys())
    n_r = len(rnames)
    rindex = {n: i for i, n in enumerate(rnames)}

    for st in all_states.values():
        st.load()

    # ---------------- species arrays ----------------
    fcounts = [len(all_states[n].freq) if all_states[n].freq is not None
               else 0 for n in snames]
    F = max(max(fcounts), 1)
    freq = np.zeros((n_s, F))
    fmask = np.zeros((n_s, F))
    mass = np.ones(n_s)
    sig = np.ones(n_s)
    inertia = np.zeros((n_s, 3))
    is_gas = np.zeros(n_s)
    is_linear = np.zeros(n_s)
    mix = np.zeros((n_s, n_s))
    gelec0 = np.zeros(n_s)
    add0 = np.zeros(n_s)
    override = {k: (np.zeros(n_s), np.zeros(n_s))
                for k in ("gvibr", "gtran", "grota", "gfree")}
    state_types = []

    for i, name in enumerate(snames):
        st = all_states[name]
        state_types.append(st.state_type)
        if st.freq is not None and st.freq.size:
            f = np.asarray(st.freq, dtype=float).ravel()
            freq[i, :len(f)] = f
            used = len(st.used_frequencies())
            fmask[i, :used] = 1.0
        if st.mass is not None:
            mass[i] = st.mass
        if st.sigma is not None:
            sig[i] = st.sigma
        if st.inertia is not None:
            vals = np.asarray(st.inertia, dtype=float).ravel()
            inertia[i, :len(vals)] = vals
        if st.state_type == GAS:
            is_gas[i] = 1.0
            if st.shape == 2:
                is_linear[i] = 1.0
        if st.gasdata is not None:
            for frac, gstate in zip(st.gasdata["fraction"], st.gasdata["state"]):
                if isinstance(gstate, State):
                    mix[i, oindex(gstate)] += frac
                else:
                    mix[i, sindex[gstate]] += frac
        if st.Gelec is not None:
            gelec0[i] = st.Gelec
        # add_to_energy is deliberately NOT baked into the spec: energy
        # modifiers are a runtime channel (Conditions.eps) so UQ noise and
        # entropy corrections batch over lanes.
        for key, attr in (("gvibr", "Gvibr"), ("gtran", "Gtran"),
                          ("grota", "Grota"), ("gfree", "Gfree")):
            val = getattr(st, attr)
            if val is not None:
                override[key][0][i] = val
                override[key][1][i] = 1.0

    # ---------------- scaling relations ----------------
    scl_names = [n for n in snames if all_states[n].is_scaling]
    n_sc = len(scl_names)
    scl_pos = {n: j for j, n in enumerate(scl_names)}
    scl_idx = np.array([sindex[n] for n in scl_names], dtype=np.int32)
    scl_b = np.zeros(n_sc)
    scl_We = np.zeros((n_sc, n_s))
    scl_Ws = np.zeros((n_sc, n_sc))
    scl_WuE = np.zeros((n_sc, n_r))

    udar_mask = np.zeros(n_s)
    udar_Ce = np.zeros((n_s, n_s))
    udar_Cg = np.zeros((n_s, n_s))
    udar_CuE = np.zeros((n_s, n_r))
    udar_CuG = np.zeros((n_s, n_r))

    def _acc_state(j_row, We, Ws, st, coeff):
        name = id2name[id(st)]
        if name in scl_pos:
            Ws[j_row, scl_pos[name]] += coeff
        else:
            We[j_row, sindex[name]] += coeff

    for name in scl_names:
        st: ScalingState = all_states[name]
        j = scl_pos[name]
        scl_b[j] = float(st.scaling_coeffs["intercept"])
        grads = st.gradients()
        mults = st.multiplicities()
        deref = 1.0 if st.dereference else 0.0
        for (rx_cfg, grad, mult) in zip(st.scaling_reactions.values(), grads, mults):
            rx: Reaction = rx_cfg["reaction"]
            ri = rindex[rx.name]
            # electronic reaction energy term: mult * grad * dE
            if rx.is_user_defined:
                scl_WuE[j, ri] += mult * grad
            else:
                for s in rx.energy_states.products:
                    _acc_state(j, scl_We, scl_Ws, s, mult * grad)
                for s in rx.energy_states.reactants:
                    _acc_state(j, scl_We, scl_Ws, s, -mult * grad)
            # dereference term: + mult * sum(reactant Gelec)
            if deref:
                for s in rx.energy_states.reactants:
                    _acc_state(j, scl_We, scl_Ws, s, mult)

        if st.use_descriptor_as_reactant:
            i = sindex[name]
            udar_mask[i] = 1.0
            for (rx_cfg, grad, mult) in zip(st.scaling_reactions.values(),
                                            st.gradients(), st.multiplicities()):
                rx: Reaction = rx_cfg["reaction"]
                ri = rindex[rx.name]
                # correction = mult * (-refE - dE + dG + refG)
                if rx.is_user_defined:
                    udar_CuE[i, ri] += -mult
                    udar_CuG[i, ri] += mult
                else:
                    for s in rx.energy_states.products:
                        udar_Ce[i, oindex(s)] += -mult            # -dE
                        udar_Cg[i, oindex(s)] += mult             # +dG
                    for s in rx.energy_states.reactants:
                        udar_Ce[i, oindex(s)] += mult             # -dE
                        udar_Cg[i, oindex(s)] += -mult            # +dG
                if deref:
                    for s in rx.energy_states.reactants:
                        udar_Ce[i, oindex(s)] += -mult            # -refE
                        udar_Cg[i, oindex(s)] += mult             # +refG

    # ---------------- reactions ----------------
    SR = np.zeros((n_r, n_s))
    SP = np.zeros((n_r, n_s))
    ST_ = np.zeros((n_r, n_s))
    has_TS = np.zeros(n_r)
    reversible = np.zeros(n_r)
    base_reversible = np.zeros(n_r)
    is_arr_type = np.zeros(n_r)
    is_ads = np.zeros(n_r)
    is_des = np.zeros(n_r)
    is_ghost = np.zeros(n_r)
    is_user = np.zeros(n_r)
    area = np.ones(n_r)
    rscaling = np.ones(n_r)
    site_density = np.zeros(n_r)
    gas_mass = np.ones(n_r)
    gas_sigma = np.ones(n_r)
    gas_inertia = np.zeros((n_r, 3))
    gas_polyatomic = np.zeros(n_r)
    reac_types = []

    arity = 1
    for rx in reactions.values():
        arity = max(arity, len(rx.reactants), len(rx.products))
    reac_idx = np.full((n_r, arity), n_s, dtype=np.int32)
    prod_idx = np.full((n_r, arity), n_s, dtype=np.int32)
    stoich = np.zeros((n_s, n_r))

    for j, rname in enumerate(rnames):
        rx = reactions[rname]
        reac_types.append(rx.reac_type)
        es = rx.energy_states
        SR[j] = _species_counts(es.reactants, oindex, n_s)
        SP[j] = _species_counts(es.products, oindex, n_s)
        if es.TS is not None:
            ST_[j] = _species_counts(es.TS, oindex, n_s)
            has_TS[j] = 1.0
        reversible[j] = 1.0 if rx.reversible else 0.0
        base_reversible[j] = 1.0 if es.reversible else 0.0
        is_arr_type[j] = 1.0 if rx.reac_type == ARRHENIUS else 0.0
        is_ads[j] = 1.0 if rx.reac_type == ADSORPTION else 0.0
        is_des[j] = 1.0 if rx.reac_type == DESORPTION else 0.0
        is_ghost[j] = 1.0 if rx.reac_type == GHOST else 0.0
        is_user[j] = 1.0 if rx.is_user_defined else 0.0
        area[j] = rx.area if rx.area else 0.0
        rscaling[j] = rx.scaling
        site_density[j] = rx.site_density
        gs = rx.gas_species()
        if gs is not None:
            gas_mass[j] = gs.mass
            gas_sigma[j] = gs.sigma
            vals = np.asarray(gs.inertia, dtype=float).ravel()
            gas_inertia[j, :len(vals)] = vals
            gas_polyatomic[j] = 1.0 if (len(vals) == 3 and
                                        np.all(np.abs(vals) > 0.001)) else 0.0

        for a, s in enumerate(rx.reactants):
            reac_idx[j, a] = oindex(s)
        for a, s in enumerate(rx.products):
            prod_idx[j, a] = oindex(s)
        # Weighted stoichiometry (reference old_system.py:239-247): surface
        # rows get +/-scaling, gas rows additionally site_density.
        for s in rx.reactants:
            i = oindex(s)
            w = rx.scaling * (rx.site_density if s.state_type == GAS else 1.0)
            stoich[i, j] -= w
        for s in rx.products:
            i = oindex(s)
            w = rx.scaling * (rx.site_density if s.state_type == GAS else 1.0)
            stoich[i, j] += w

    # ---------------- conservation / reactor ----------------
    is_adsorbate = np.zeros(n_s)
    is_gas_dyn = np.zeros(n_s)
    for rx in reactions.values():
        for s in list(rx.reactants) + list(rx.products):
            i = oindex(s)
            if s.state_type in (ADSORBATE, SURFACE):
                is_adsorbate[i] = 1.0
            elif s.state_type == GAS:
                is_gas_dyn[i] = 1.0
    adsorbate_indices = np.flatnonzero(is_adsorbate).astype(np.int32)
    gas_indices = np.flatnonzero(is_gas_dyn).astype(np.int32)

    rtype = REACTOR_ID if reactor is None else reactor
    if rtype == REACTOR_CSTR:
        dynamic_indices = np.concatenate([adsorbate_indices, gas_indices])
    else:
        dynamic_indices = adsorbate_indices.copy()

    # Site-conservation groups: per explicit surface (adsorbates associated
    # by name prefix, reference system.py:224-247) or, absent explicit
    # surface states, one group with every surface-bound species (the
    # legacy/DMTM convention).
    # Only SYSTEM states define site groups: foreign energy-only species
    # (derived-reaction bases) never carry coverage.
    surfaces = [n for n in snames
                if n in states and states[n].state_type == SURFACE]
    groups = []
    if surfaces:
        for surf in sorted(surfaces):
            g = np.zeros(n_s)
            g[sindex[surf]] = 1.0
            for n in snames:
                if (all_states[n].state_type == ADSORBATE and n[0] == surf
                        and is_adsorbate[sindex[n]]):
                    g[sindex[n]] = 1.0
            groups.append(g)
        covered = np.sum(groups, axis=0)
        leftover = is_adsorbate * (covered == 0)
        if leftover.any():
            # Adsorbates the name-prefix rule did not associate with any
            # surface: with exactly ONE surface in the system they must be
            # its adsorbates (e.g. Butadiene-style '*'/'H*' naming, where
            # no adsorbate name starts with '*'). With multiple surfaces
            # but exactly one that matched nothing, assume (and warn, so a
            # mis-assignment is visible) that the leftovers are its
            # adsorbates; otherwise the association is ambiguous and they
            # get their own conservation group, with a warning.
            names = [snames[i] for i in np.flatnonzero(leftover)]
            lonely = [k for k, g in enumerate(groups) if g.sum() == 1.0]
            if len(surfaces) == 1:
                groups[0] = np.maximum(groups[0], leftover)
            elif len(lonely) == 1:
                import warnings
                warnings.warn(
                    f"adsorbates {names} match no surface by name prefix; "
                    f"assuming they occupy {sorted(surfaces)[lonely[0]]!r} "
                    "(the only surface with no prefix-matched adsorbates)",
                    stacklevel=2)
                groups[lonely[0]] = np.maximum(groups[lonely[0]], leftover)
            else:
                import warnings
                warnings.warn(
                    f"adsorbates {names} match no surface by name prefix "
                    f"(surfaces: {sorted(surfaces)}); giving them their own "
                    "site-conservation group", stacklevel=2)
                groups.append(leftover)
    else:
        groups.append(is_adsorbate.copy())
    groups = np.asarray(groups)

    params = reactor_params or {}
    residence_time = params.get("residence_time")
    if (rtype == REACTOR_CSTR and residence_time is None):
        residence_time = params["volume"] / params["flow_rate"]

    return ModelSpec(
        snames=snames, state_types=tuple(state_types),
        freq=freq, fmask=fmask, mass=mass, sigma=sig, inertia=inertia,
        is_gas=is_gas, is_linear=is_linear, mix=mix, gelec0=gelec0,
        add0=add0,
        gvibr0=override["gvibr"][0], gvibr_mask=override["gvibr"][1],
        gtran0=override["gtran"][0], gtran_mask=override["gtran"][1],
        grota0=override["grota"][0], grota_mask=override["grota"][1],
        gfree0=override["gfree"][0], gfree_mask=override["gfree"][1],
        scl_idx=scl_idx, scl_b=scl_b, scl_We=scl_We, scl_Ws=scl_Ws,
        scl_WuE=scl_WuE,
        udar_mask=udar_mask, udar_Ce=udar_Ce, udar_Cg=udar_Cg,
        udar_CuE=udar_CuE, udar_CuG=udar_CuG,
        rnames=rnames, reac_types=tuple(reac_types),
        SR=SR, SP=SP, ST=ST_, has_TS=has_TS, reversible=reversible,
        base_reversible=base_reversible,
        is_arr_type=is_arr_type, is_ads=is_ads, is_des=is_des,
        is_ghost=is_ghost, is_user=is_user, area=area, rscaling=rscaling,
        site_density=site_density, gas_mass=gas_mass, gas_sigma=gas_sigma,
        gas_inertia=gas_inertia, gas_polyatomic=gas_polyatomic,
        reac_idx=reac_idx, prod_idx=prod_idx, stoich=stoich,
        reactor_type=rtype,
        volume=params.get("volume"),
        catalyst_area=params.get("catalyst_area"),
        residence_time=residence_time,
        is_adsorbate=is_adsorbate, is_gas_dyn=is_gas_dyn,
        dynamic_indices=dynamic_indices.astype(np.int32),
        adsorbate_indices=adsorbate_indices, gas_indices=gas_indices,
        groups=groups, desorption_model=desorption_model,
    )


def default_conditions(spec: ModelSpec, reactions: dict, T: float, p: float,
                       start_state: dict | None = None,
                       inflow_state: dict | None = None,
                       gelec_overrides: dict | None = None,
                       eps: dict | np.ndarray | None = None,
                       kscale: np.ndarray | None = None) -> Conditions:
    """Assemble a :class:`Conditions` pytree from host-side objects.

    Re-reads user energies from the (possibly mutated) reaction objects --
    the bridge between the reference's mutate-and-solve style and the
    engine's functional style.
    """
    n_s, n_r = spec.n_species, spec.n_reactions
    uE = np.zeros(n_r)
    uG = np.zeros(n_r)
    uEa = np.zeros(n_r)
    uGa = np.zeros(n_r)
    u_rxn_mask = np.zeros(n_r)
    u_bar_mask = np.zeros(n_r)
    is_activated = np.zeros(n_r)

    for j, rname in enumerate(spec.rnames):
        rx = reactions[rname]
        if isinstance(rx, UserDefinedReaction):
            vals = rx.resolved_user_energies(T)
            if vals["has_rxn_energy"]:
                uE[j] = vals["dErxn"]
                uG[j] = vals["dGrxn"]
                u_rxn_mask[j] = 1.0
            uEa[j] = vals["dEa_fwd"]
            uGa[j] = vals["dGa_fwd"]
            if vals["has_barrier"]:
                u_bar_mask[j] = 1.0
            # Reference dispatch (reaction.py:121): Arrhenius expression if
            # declared Arrhenius OR the resolved forward barrier is truthy.
            is_activated[j] = 1.0 if (spec.is_arr_type[j] or
                                      vals["dGa_fwd"]) else 0.0
        else:
            is_activated[j] = 1.0 if (spec.is_arr_type[j] or
                                      spec.has_TS[j]) else 0.0

    gelec = spec.gelec0.copy()
    if gelec_overrides:
        for name, val in gelec_overrides.items():
            gelec[spec.sindex(name)] = val

    eps_vec = np.zeros(n_s)
    if isinstance(eps, dict):
        for name, val in eps.items():
            eps_vec[spec.sindex(name)] = val
    elif eps is not None:
        eps_vec = np.asarray(eps, dtype=float)

    y0 = np.zeros(n_s)
    for name, val in (start_state or {}).items():
        y0[spec.sindex(name)] = val
    inflow = np.zeros(n_s)
    for name, val in (inflow_state or {}).items():
        inflow[spec.sindex(name)] = val

    return Conditions(
        T=float(T), p=float(p), gelec=gelec, eps=eps_vec,
        uE_rxn=uE, uG_rxn=uG, uEa=uEa, uGa=uGa,
        u_rxn_mask=u_rxn_mask, u_bar_mask=u_bar_mask,
        is_activated=is_activated,
        kscale=(np.ones(n_r) if kscale is None
                else np.asarray(kscale, dtype=float)),
        y0=y0, inflow=inflow,
    )


def spec_to_arrays(spec: ModelSpec) -> dict:
    """Every field of ``spec`` as a dict (the form
    :func:`spec_from_arrays` takes)."""
    return {f.name: getattr(spec, f.name) for f in dataclasses.fields(spec)}


def spec_from_arrays(d: dict) -> ModelSpec:
    """Build this package's :class:`ModelSpec` from a dict of its fields
    (numpy arrays, scalars and tuples) -- e.g. the fields of a spec the
    JAX package compiled. Arrays are copied so the two specs share no
    memory; every field must be present and no other."""
    names = [f.name for f in dataclasses.fields(ModelSpec)]
    missing = sorted(set(names) - set(d))
    extra = sorted(set(d) - set(names))
    if missing or extra:
        raise ValueError(f"spec fields missing {missing}, unknown {extra}")

    def conv(v):
        if isinstance(v, np.ndarray):
            return np.array(v, copy=True)
        if isinstance(v, (list, tuple)):
            return tuple(v)
        return v
    return ModelSpec(**{n: conv(d[n]) for n in names})


def conditions_from_arrays(d) -> Conditions:
    """Build this package's :class:`Conditions` from a dict (or any
    object with the same field attributes, such as the JAX package's
    ``Conditions``). Array fields become float64 numpy arrays, scalars
    stay Python floats."""
    get = (d.__getitem__ if isinstance(d, dict)
           else lambda k: getattr(d, k))

    def conv(v):
        a = np.asarray(v, dtype=np.float64)
        return float(a) if a.ndim == 0 else np.array(a, copy=True)
    return Conditions(**{f: conv(get(f)) for f in Conditions._fields})
