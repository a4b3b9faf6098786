"""Seeded synthetic microkinetic networks for benchmarks and scaling tests.

Port of ``synthetic_system`` (``pycatkin_tpu/models/synthetic.py``): a
star of adsorption steps feeding a random surface reaction graph, with
barriers drawn over a wide range so rate constants span many decades.
It builds the same :class:`State` / :class:`Reaction` objects, draws
from ``np.random.default_rng(seed)`` in the same order and compiles them
with this package's :func:`build_spec` / :func:`default_conditions`
directly (there is no ``System`` facade in the port yet), so the spec
comes out field for field identical to the JAX package's.
"""

from __future__ import annotations

import numpy as np

from ..frontend.reactions import ADSORPTION, ARRHENIUS, Reaction
from ..frontend.spec import Conditions, ModelSpec, build_spec, \
    default_conditions
from ..frontend.states import ADSORBATE, GAS, SURFACE, TS, State
from .reactor import InfiniteDilutionReactor


def synthetic_spec(n_species: int = 200, n_reactions: int = 500,
                   seed: int = 0, T: float = 500.0, p: float = 1.0e5,
                   barrier_range: tuple = (0.1, 1.6)
                   ) -> tuple[ModelSpec, Conditions]:
    """A random but reproducible mechanism as ``(spec, base conditions)``.

    ``n_species`` counts solution-vector species (gas + surface +
    adsorbates); transition states are extra. ``n_reactions`` =
    adsorption steps (one per gas) + random reversible surface steps.
    """
    rng = np.random.default_rng(seed)
    n_gas = max(2, n_species // 20)
    n_ads = n_species - n_gas - 1
    assert n_ads >= n_gas, "n_species too small for the gas count"
    assert n_reactions > n_gas, "need more reactions than gas species"

    states: dict = {}
    reactions: dict = {}

    def add_state(st):
        if st.name in states:
            raise ValueError(f"Found two copies of state {st.name}.")
        states[st.name] = st

    surf = State(name="s", state_type=SURFACE, freq=[], Gelec=0.0)
    add_state(surf)

    gas_states = []
    for g in range(n_gas):
        mass = float(rng.uniform(2.0, 60.0))
        linear = bool(rng.random() < 0.3)
        i1, i2, i3 = rng.uniform(2.0, 60.0, size=3)
        inertia = [i1, i1, 0.0] if linear else [i1, i2, i3]
        st = State(name=f"G{g:03d}", state_type=GAS, mass=mass,
                   sigma=float(rng.integers(1, 3)), inertia=inertia,
                   freq=list(rng.uniform(2.0e13, 9.0e13, size=3)),
                   Gelec=float(rng.uniform(-0.5, 0.5)))
        add_state(st)
        gas_states.append(st)

    ads_states = []
    for a in range(n_ads):
        st = State(name=f"sA{a:03d}", state_type=ADSORBATE,
                   freq=list(rng.uniform(1.0e12, 6.0e13, size=3)),
                   Gelec=float(rng.uniform(-1.2, 0.3)))
        add_state(st)
        ads_states.append(st)

    for g, gst in enumerate(gas_states):
        rx = Reaction(name=f"ads{g:03d}", reac_type=ADSORPTION,
                      reversible=True, reactants=[gst, surf],
                      products=[ads_states[g]], area=1.0e-19)
        reactions[rx.name] = rx

    for j in range(n_reactions - n_gas):
        ia, ib = rng.choice(n_ads, size=2, replace=False)
        ra, rb = ads_states[ia], ads_states[ib]
        barrier = float(rng.uniform(*barrier_range))
        ets = max(ra.Gelec, rb.Gelec) + barrier
        ts = State(name=f"TS{j:03d}", state_type=TS,
                   freq=list(rng.uniform(1.0e12, 6.0e13, size=3)),
                   Gelec=ets)
        add_state(ts)
        rx = Reaction(name=f"r{j:03d}", reac_type=ARRHENIUS,
                      reversible=True, reactants=[ra], products=[rb],
                      TS=[ts], area=1.0e-19)
        reactions[rx.name] = rx

    reactor = InfiniteDilutionReactor()
    spec = build_spec(states, reactions, reactor=reactor.reactor_type,
                      reactor_params=reactor.params())
    start = {"s": 1.0}
    frac = (p / 1.0e5) / n_gas
    for gst in gas_states:
        start[gst.name] = frac
    conds = default_conditions(
        spec, reactions, T=T, p=p, start_state=start,
        gelec_overrides={n: st.Gelec for n, st in states.items()
                         if st.Gelec is not None},
        eps={n: st.add_to_energy for n, st in states.items()
             if st.add_to_energy})
    return spec, conds
