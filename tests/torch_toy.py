"""A small mechanism built in code with either package's own classes, for
the tests that hold the port's facade and presets against the JAX
package's (and for the card tests, which import no JAX): A(g) + * <->
A*, A* <-> B* through TS1, B(g) + * <-> B*, in an infinite-dilution
reactor at 500 K, with an energy landscape over the cycle. A twin of
``tests/test_legacy_knobs.py``'s toy with gas, a transition state and a
landscape."""

import importlib

TOF = ["rAB"]


def toy(pkg, **kw):
    """The toy mechanism as a System of package ``pkg``."""
    mod = lambda m: importlib.import_module(f"{pkg}.{m}")
    State = mod("frontend.states").State
    Reaction = mod("frontend.reactions").Reaction
    s = State(name="s", state_type="surface", freq=[], Gelec=0.0)
    A = State(name="A", state_type="gas", mass=28.0, sigma=1.0,
              inertia=[8.7, 8.7, 0.0], freq=[6.4e13], Gelec=0.0)
    B = State(name="B", state_type="gas", mass=44.0, sigma=2.0,
              inertia=[43.0, 43.0, 0.0],
              freq=[7.0e13, 4.0e13, 2.0e13, 2.0e13], Gelec=-0.6)
    sA = State(name="sA", state_type="adsorbate",
               freq=[5.0e13, 1.0e13, 8.0e12], Gelec=-0.7)
    sB = State(name="sB", state_type="adsorbate",
               freq=[6.0e13, 2.0e13, 9.0e12], Gelec=-1.0)
    ts = State(name="TS1", state_type="TS", freq=[4.0e13, 1.0e13],
               Gelec=-0.1)
    sim = mod("api.system").System(
        start_state={"s": 1.0, "A": 0.5, "B": 0.1}, T=500.0, p=1.0e5,
        times=[1e-8, 1.0e2], n_out=12, **kw)
    for st in (s, A, B, sA, sB, ts):
        sim.add_state(st)
    sim.add_reaction(Reaction(name="adsA", reac_type="adsorption",
                              reversible=True, reactants=[A, s],
                              products=[sA], area=1.0e-19))
    sim.add_reaction(Reaction(name="rAB", reac_type="arrhenius",
                              reversible=True, reactants=[sA],
                              products=[sB], TS=[ts], area=1.0e-19))
    sim.add_reaction(Reaction(name="adsB", reac_type="adsorption",
                              reversible=True, reactants=[B, s],
                              products=[sB], area=1.0e-19))
    sim.add_reactor(mod("models.reactor").InfiniteDilutionReactor())
    sim.add_energy_landscape(mod("analysis.energy_span").Energy(
        name="pes", minima=[[A, s], [sA], [ts], [sB], [B, s]],
        labels=["A+s", "sA", "TS1", "sB", "B+s"]))
    return sim.build()
