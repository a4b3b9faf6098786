"""Seeded synthetic microkinetic networks for benchmarks and scaling tests.

Port of ``pycatkin_tpu/models/synthetic.py``: a star of adsorption steps
feeding a random surface reaction graph, with barriers drawn over a wide
range so rate constants span many decades (the stiffness profile of real
DFT landscapes). :func:`synthetic_system` builds the same :class:`State`
/ :class:`Reaction` objects into the port's :class:`System`, drawing
from ``np.random.default_rng(seed)`` in the same order, so its spec and
conditions come out field for field the JAX package's;
:func:`synthetic_spec` returns them as ``(spec, conditions)``.
"""

from __future__ import annotations

import numpy as np

from ..api.system import System
from ..frontend.reactions import ADSORPTION, ARRHENIUS, Reaction
from ..frontend.spec import Conditions, ModelSpec
from ..frontend.states import ADSORBATE, GAS, SURFACE, TS, State
from .reactor import InfiniteDilutionReactor


def synthetic_system(n_species: int = 200, n_reactions: int = 500,
                     seed: int = 0, T: float = 500.0, p: float = 1.0e5,
                     barrier_range: tuple = (0.1, 1.6),
                     device=None) -> System:
    """Build a random but reproducible mechanism as a :class:`System`.

    ``n_species`` counts solution-vector species (gas + surface +
    adsorbates); transition states are extra. ``n_reactions`` =
    adsorption steps (one per gas) + random reversible surface steps.
    Barriers in ``barrier_range`` eV give rate constants spanning ~15
    decades at 500 K -- comparable stiffness to the DMTM example.
    """
    rng = np.random.default_rng(seed)
    n_gas = max(2, n_species // 20)
    n_ads = n_species - n_gas - 1
    assert n_ads >= n_gas, "n_species too small for the gas count"
    assert n_reactions > n_gas, "need more reactions than gas species"

    sys = System(T=T, p=p, times=[0.0, 1.0e6], device=device)
    surf = State(name="s", state_type=SURFACE, freq=[], Gelec=0.0)
    sys.add_state(surf)

    gas_states = []
    for g in range(n_gas):
        mass = float(rng.uniform(2.0, 60.0))
        linear = bool(rng.random() < 0.3)
        i1, i2, i3 = rng.uniform(2.0, 60.0, size=3)
        inertia = [i1, i1, 0.0] if linear else [i1, i2, i3]
        # Distinct gas energies keep the clamped-gas steady state away
        # from global equilibrium, so cycles carry sustained flux and the
        # TOF is a meaningful benchmark quantity.
        st = State(name=f"G{g:03d}", state_type=GAS, mass=mass,
                   sigma=float(rng.integers(1, 3)), inertia=inertia,
                   freq=list(rng.uniform(2.0e13, 9.0e13, size=3)),
                   Gelec=float(rng.uniform(-0.5, 0.5)))
        sys.add_state(st)
        gas_states.append(st)

    ads_states = []
    for a in range(n_ads):
        st = State(name=f"sA{a:03d}", state_type=ADSORBATE,
                   freq=list(rng.uniform(1.0e12, 6.0e13, size=3)),
                   Gelec=float(rng.uniform(-1.2, 0.3)))
        sys.add_state(st)
        ads_states.append(st)

    # One non-activated adsorption step per gas, each onto its own site
    # species: G + s -> sA  (collision-theory kf, detailed-balance kr).
    for g, gst in enumerate(gas_states):
        sys.add_reaction(Reaction(
            name=f"ads{g:03d}", reac_type=ADSORPTION, reversible=True,
            reactants=[gst, surf], products=[ads_states[g]],
            area=1.0e-19))

    # Random reversible surface interconversions sX -> sY through a TS
    # whose electronic energy sits ``barrier`` above the higher end.
    n_surface_rxns = n_reactions - n_gas
    for j in range(n_surface_rxns):
        ia, ib = rng.choice(n_ads, size=2, replace=False)
        ra, rb = ads_states[ia], ads_states[ib]
        barrier = float(rng.uniform(*barrier_range))
        ets = max(ra.Gelec, rb.Gelec) + barrier
        ts = State(name=f"TS{j:03d}", state_type=TS,
                   freq=list(rng.uniform(1.0e12, 6.0e13, size=3)),
                   Gelec=ets)
        sys.add_state(ts)
        sys.add_reaction(Reaction(
            name=f"r{j:03d}", reac_type=ARRHENIUS, reversible=True,
            reactants=[ra], products=[rb], TS=[ts], area=1.0e-19))

    sys.add_reactor(InfiniteDilutionReactor())
    start = {"s": 1.0}
    frac = (p / 1.0e5) / n_gas
    for gst in gas_states:
        start[gst.name] = frac
    sys.params["start_state"] = start
    return sys


# Bucket-targeted shapes: one FIXED (n_species, n_reactions) pair per
# ABI species bucket. Fixing the shape (rather than drawing it from
# the seed) pins the whole fingerprint -- padded dims, dynamic
# sub-bucket, reactor code -- so every seed of a bucket lands in the
# SAME interned program spec and the serving layer's coalescer can
# pack them as co-tenants. The ABI counts TS states too, so the
# lowered species count is n_species + n_reactions - n_gas (one TS
# per surface step); shapes below sit mid-bucket under that formula.
_BUCKET_SHAPES = {
    16: (10, 5),
    32: (15, 12),
    128: (60, 40),
    512: (200, 200),
}


def _lowered_species(n_species: int, n_reactions: int) -> int:
    n_gas = max(2, n_species // 20)
    return n_species + n_reactions - n_gas


def synthetic_system_for_bucket(species_bucket: int, seed: int = 0,
                                n_species: int | None = None,
                                n_reactions: int | None = None,
                                T: float = 500.0, p: float = 1.0e5,
                                barrier_range: tuple = (0.1, 1.6),
                                device=None) -> System:
    """A :func:`synthetic_system` guaranteed to lower into the
    requested ABI species bucket -- the soak harness's occupancy
    control knob of the JAX package's serving layer: mechanisms generated
    with the same ``species_bucket`` (any seed) share one ABI
    fingerprint.

    ``n_species`` / ``n_reactions`` override the bucket's default
    shape but are validated against it; an impossible request (unknown
    bucket, a species count that lowers elsewhere, a reaction count
    the generator cannot realize) raises ``ValueError`` with the
    reason rather than silently generating a mechanism in the wrong
    bucket. The build is verified by actually lowering the spec
    through :func:`frontend.abi.select_static`."""
    from ..frontend import abi

    if species_bucket not in abi.SPECIES_BUCKETS:
        raise ValueError(
            f"species_bucket {species_bucket} is not an ABI bucket; "
            f"choose one of {abi.SPECIES_BUCKETS}")
    lo = ([b for b in abi.SPECIES_BUCKETS if b < species_bucket]
          or [0])[-1]
    n_s, n_r = _BUCKET_SHAPES[species_bucket]
    if n_species is not None:
        n_s = int(n_species)
    if n_reactions is not None:
        n_r = int(n_reactions)
    n_gas = max(2, n_s // 20)
    # +1 below mirrors abi.select_static's reserved pad slot.
    total = _lowered_species(n_s, n_r)
    if not (lo < total + 1 <= species_bucket):
        raise ValueError(
            f"n_species={n_s}/n_reactions={n_r} lower to {total} ABI "
            f"species (TS states included), i.e. bucket "
            f"{abi._bucket_for(total + 1, abi.SPECIES_BUCKETS)}, not "
            f"the requested {species_bucket} (need {lo} < "
            f"n_species + n_reactions - {n_gas} + 1 <= {species_bucket})")
    if n_s - n_gas - 1 < n_gas:
        raise ValueError(
            f"n_species={n_s} is too small for the generator's gas "
            f"star ({n_gas} gas species need at least as many "
            f"adsorbates)")
    if n_r <= n_gas:
        raise ValueError(
            f"n_reactions={n_r} cannot cover the {n_gas} adsorption "
            f"steps the generator emits (need n_reactions > {n_gas})")
    if n_r > max(abi.REACTION_BUCKETS):
        raise ValueError(
            f"n_reactions={n_r} exceeds the largest ABI reaction "
            f"bucket {max(abi.REACTION_BUCKETS)}")
    sys = synthetic_system(n_species=n_s, n_reactions=n_r, seed=seed,
                           T=T, p=p, barrier_range=barrier_range,
                           device=device)
    st = abi.select_static(sys.spec)
    if st.n_species != species_bucket:
        raise ValueError(
            f"generated mechanism lowered into species bucket "
            f"{st.n_species}, not the requested {species_bucket} "
            f"(generator/ABI drift -- report this)")
    return sys


def synthetic_spec(n_species: int = 200, n_reactions: int = 500,
                   seed: int = 0, T: float = 500.0, p: float = 1.0e5,
                   barrier_range: tuple = (0.1, 1.6)
                   ) -> tuple[ModelSpec, Conditions]:
    """:func:`synthetic_system` as ``(spec, base conditions)``, compiled
    without the input-validation gate (a synthetic mechanism leaves
    orphan adsorbates by design, one warning each)."""
    sys = synthetic_system(n_species, n_reactions, seed=seed, T=T, p=p,
                           barrier_range=barrier_range)
    return sys.build(strict=False).spec, sys.conditions()
