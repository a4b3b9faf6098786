"""The port's frontend and engine on the features the synthetic generator
never emits: a CSTR reactor (gas rows dynamic, sigma and flow terms), a
user-defined reaction, a linear scaling state with
``use_descriptor_as_reactant`` and ``dereference``, a non-activated
desorption step and a gas mixture (``gasdata``). The same mechanism is
built with each package's own frontend; the specs must agree field for
field, and the rate chain, residual and Jacobian must agree with the
JAX engine at rtol 1e-12 (absolute floors as in test_torch_rates.py /
test_torch_network.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pycatkin_tpu.frontend.reactions as jreactions
import pycatkin_tpu.frontend.spec as jspec
import pycatkin_tpu.frontend.states as jstates
import pycatkin_tpu.models.reactor as jreactor
import pycatkin_tpu_torch.frontend.reactions as treactions
import pycatkin_tpu_torch.frontend.spec as tspec
import pycatkin_tpu_torch.frontend.states as tstates
import pycatkin_tpu_torch.models.reactor as treactor
from pycatkin_tpu import engine as jengine
from pycatkin_tpu.parallel.batch import broadcast_conditions
from pycatkin_tpu_torch import engine

RTOL = 1e-12
L = 6


def _mechanism(states_mod, reactions_mod, spec_mod, reactor_mod, T=550.0):
    S, R = states_mod, reactions_mod
    s = S.State(name="s", state_type=S.SURFACE, freq=[], Gelec=0.0)
    A = S.State(name="A", state_type=S.GAS, mass=28.0, sigma=1.0,
                inertia=[8.7, 8.7, 0.0], freq=[6.5e13], Gelec=-0.2)
    B = S.State(name="B", state_type=S.GAS, mass=44.0, sigma=2.0,
                inertia=[43.0, 43.0, 0.1], freq=[4.0e13, 2.0e13, 1.9e13],
                Gelec=-0.6)
    sA = S.State(name="sA", state_type=S.ADSORBATE,
                 freq=[5.0e13, 1.2e13, 7.0e12], Gelec=-1.0,
                 gasdata={"fraction": [0.25], "state": [A]})
    sB = S.State(name="sB", state_type=S.ADSORBATE,
                 freq=[4.0e13, 1.0e13], Gelec=-1.3, add_to_energy=0.05)
    ts = S.State(name="TS1", state_type=S.TS,
                 freq=[3.0e13, 1.1e13, 9.0e12], Gelec=-0.3)
    desc = R.UserDefinedReaction(
        name="desc", reac_type="arrhenius", reactants=[sA], products=[sB],
        dErxn_user=-0.3, dEa_fwd_user={400.0: 0.55, 800.0: 0.45},
        area=1.0e-19)
    sC = S.ScalingState(
        name="sC", state_type=S.ADSORBATE, freq=[3.3e13, 8.0e12],
        scaling_coeffs={"gradient": 0.6, "intercept": -0.4},
        scaling_reactions={"desc": {"reaction": desc,
                                    "multiplicity": 1.0}},
        dereference=True, use_descriptor_as_reactant=True)
    states = {st.name: st for st in (s, A, B, sA, sB, ts, sC)}
    rxs = [
        R.Reaction(name="adsA", reac_type=R.ADSORPTION,
                   reactants=[A, s], products=[sA], area=1.0e-19),
        desc,
        R.Reaction(name="step", reac_type=R.ARRHENIUS, reactants=[sA],
                   products=[sC], TS=[ts], area=1.0e-19, scaling=0.5),
        R.Reaction(name="conv", reac_type=R.ARRHENIUS, reactants=[sC],
                   products=[sB], TS=[ts], area=1.0e-19),
        R.Reaction(name="desB", reac_type=R.DESORPTION, reactants=[sB],
                   products=[B, s], area=1.0e-19),
    ]
    reactions = {rx.name: rx for rx in rxs}
    reactor = reactor_mod.CSTReactor(volume=1.0e-6, catalyst_area=1.0e-4,
                                     flow_rate=2.0e-8)
    spec = spec_mod.build_spec(states, reactions,
                               reactor=reactor.reactor_type,
                               reactor_params=reactor.params())
    cond = spec_mod.default_conditions(
        spec, reactions, T=T, p=1.0e5,
        start_state={"s": 1.0, "A": 0.3, "B": 0.1},
        inflow_state={"A": 0.8, "B": 0.05},
        gelec_overrides={n: st.Gelec for n, st in states.items()
                         if st.Gelec is not None},
        eps={n: st.add_to_energy for n, st in states.items()
             if st.add_to_energy})
    return spec, cond


@pytest.fixture(scope="module")
def built():
    sj, cj0 = _mechanism(jstates, jreactions, jspec, jreactor)
    sp, cp0 = _mechanism(tstates, treactions, tspec, treactor)
    cj = broadcast_conditions(cj0, L)._replace(
        T=jnp.linspace(400.0, 800.0, L))
    ct = engine.conditions_to(tspec.conditions_from_arrays(
        {f: np.asarray(getattr(cj, f)) for f in cj._fields}), "cpu")
    return sj, cj0, cj, sp, cp0, ct


def test_features_are_present(built):
    sj = built[0]
    assert sj.reactor_type == jspec.REACTOR_CSTR
    assert sj.scl_idx.size == 1 and sj.has_udar
    assert sj.is_user.any() and sj.is_des.any() and sj.mix.any()
    assert sj.gas_indices.size and set(sj.gas_indices) <= set(
        sj.dynamic_indices)


def test_spec_and_conditions_match_field_for_field(built):
    sj, cj0, _, sp, cp0, _ = built
    for f in dataclasses.fields(sj):
        a, b = getattr(sj, f.name), getattr(sp, f.name)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), f.name
        else:
            assert a == b, f.name
    for f in cj0._fields:
        assert np.array_equal(np.asarray(getattr(cj0, f)),
                              np.asarray(getattr(cp0, f))), f


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    atol = RTOL * max(float(np.max(np.abs(b))), 1e-300)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=atol, err_msg=what)


def test_rate_chain_matches_jax(built):
    sj, _, cj, sp, _, ct = built
    ds = engine.bind(sp, "cpu")
    fj = jax.vmap(lambda c: jengine.free_energies(sj, c))(cj)
    ft = engine.free_energies(ds, ct)
    for name in fj._fields:
        _close(getattr(ft, name).numpy(), getattr(fj, name), name)
    rj = jax.vmap(lambda c: jengine.reaction_energies(sj, c))(cj)
    rt = engine.reaction_energies(ds, ct)
    for name in rj._fields:
        _close(getattr(rt, name).numpy(), getattr(rj, name), name)
    kj = jax.vmap(lambda c: jengine.rate_constants(sj, c))(cj)
    for name, a, b in zip(("kf", "kr", "Keq"),
                          engine.rate_constants(ds, ct), kj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=0.0, err_msg=name)


def test_cstr_residual_and_jacobian_match_jax(built):
    sj, _, cj, sp, _, ct = built
    n_dyn = len(sj.dynamic_indices)
    x = np.random.default_rng(5).uniform(0.01, 0.5, (L, n_dyn))

    def one(c, xx):
        kf, kr, _ = jengine.rate_constants(sj, c)
        fs, _, _ = jengine._dynamic_fscale(sj, c, kf, kr)
        F, g = fs(xx)
        return F, g, jax.jacfwd(lambda z: fs(z)[0])(xx)
    Fj, gj, Jj = (np.asarray(a) for a in
                  jax.jit(jax.vmap(one))(cj, jnp.asarray(x)))
    ds = engine.bind(sp, "cpu")
    kf, kr, _ = engine.rate_constants(ds, ct)
    cl = engine.closures(ds, ct, kf, kr)
    xt = torch.tensor(x, dtype=torch.float64)
    Ft, gt = (a.numpy() for a in cl.fscale(xt))
    Jt = cl.jac(xt).numpy()
    Jc = engine.closed_form_jacobian(ds, ct, xt).numpy()
    np.testing.assert_allclose(gt, gj, rtol=RTOL, atol=0.0)
    assert np.all(np.abs(Ft - Fj) <= RTOL * (np.abs(Fj) + gj))
    scale = np.max(np.abs(Jj), axis=(1, 2))[:, None, None]
    assert np.all(np.abs(Jt - Jj) <= RTOL * (np.abs(Jj) + scale))
    assert np.all(np.abs(Jt - Jc) <= RTOL * (np.abs(Jc) + scale))
