"""System: the user-facing facade over the lane-batched engine (port of
``pycatkin_tpu/api/system.py``).

One class carries the union of upstream PyCatKin's two System APIs: a
legacy ``params`` dict with ``solve_odes`` / DRC / activity, and the
``build`` / ``get_dydt`` / ``find_steady`` style. Host-side mutation of
states, reactions or params is compiled into a fresh :class:`Conditions`
on each call, so mutate-and-solve workflows keep working while the
arithmetic runs on the device as one-lane batches of the port's engine.

``device=None`` runs every computation on the CUDA card (and raises
when there is none); pass ``device="cpu"`` for the CPU. Building,
loading and the tables' bookkeeping need no device; the device is
resolved when a computation first runs.
"""

from __future__ import annotations

import copy
import warnings
from typing import Optional

import numpy as np
import torch

from .. import engine
from ..analysis.energy_span import Energy
from ..frontend.reactions import Reaction
from ..frontend.spec import Conditions, build_spec, default_conditions
from ..frontend.states import State
from ..models.reactor import Reactor
from ..ops import prng
from ..parallel.batch import broadcast_conditions, resolve_device
from ..solvers.newton import SolverOptions, SteadyStateResults
from ..solvers.ode import ODEOptions, log_time_grid


def _host(t):
    """A device tensor as a numpy array (anything else as it is)."""
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


class System:

    def __init__(self, times=None, start_state=None, inflow_state=None,
                 T=293.15, p=101325.0, use_jacobian=True,
                 ode_solver="trbdf2", nsteps=1.0e4, rtol=1.0e-8,
                 atol=1.0e-10, xtol=1.0e-8, ftol=1.0e-8, verbose=False,
                 min_tol=1.0e-32, n_out=300,
                 desorption_model="detailed_balance", device=None):
        # Desorption convention of non-activated ads/des steps:
        # 'detailed_balance' (upstream) or 'collision'.
        if desorption_model not in ("detailed_balance", "collision"):
            raise ValueError(
                f"desorption_model must be 'detailed_balance' or "
                f"'collision', got {desorption_model!r}")
        self.desorption_model = desorption_model
        # ode_solver: 'trbdf2' (the default) or 'esdirk4'; the upstream
        # schema values 'solve_ivp' and 'ode' alias the default. nsteps
        # is the per-save-interval step cap; ftol/xtol: the tightest is
        # the absolute residual tolerance of the steady solve.
        if ode_solver not in ("trbdf2", "esdirk4", "solve_ivp", "ode"):
            raise ValueError(
                f"ode_solver={ode_solver!r} is not supported: use "
                "'trbdf2' or 'esdirk4' (the native L-stable stiff "
                "integrators) or the reference-schema aliases "
                "'solve_ivp'/'ode', which map onto the default.")
        self.params = {
            "times": copy.deepcopy(times),
            "start_state": copy.deepcopy(start_state) or {},
            "inflow_state": copy.deepcopy(inflow_state) or {},
            "temperature": T,
            "pressure": p,
            "rtol": rtol,
            "atol": atol,
            "xtol": xtol,
            "ftol": ftol,
            "jacobian": use_jacobian,
            "nsteps": int(nsteps),
            "ode_solver": ode_solver,
            "verbose": verbose,
            "n_out": int(n_out),
        }
        self.min_tol = min_tol
        self.states: dict[str, State] = {}
        self.reactions: dict[str, Reaction] = {}
        self.reactor: Optional[Reactor] = None
        self.energy_landscapes: dict[str, Energy] = {}
        self.device_request = device

        self._spec = None
        self._ds = None
        self.times = None
        self.solution = None
        self.full_steady = None
        self.steady_result: Optional[SteadyStateResults] = None

    # -- new-API style scalar accessors --------------------------------
    @property
    def T(self):
        return self.params["temperature"]

    @T.setter
    def T(self, value):
        self.params["temperature"] = value

    @property
    def p(self):
        return self.params["pressure"]

    @p.setter
    def p(self, value):
        self.params["pressure"] = value

    @property
    def verbose(self):
        return self.params["verbose"]

    @property
    def device(self) -> torch.device:
        """The device the computations run on (None: the CUDA card)."""
        return resolve_device(self.device_request)

    # ------------------------------------------------------------------
    # construction
    def add_state(self, state: State):
        assert isinstance(state, State), \
            "state must be a pycatkin_tpu_torch State"
        if state.name in self.states:
            raise ValueError(
                f"Found two copies of state {state.name}. "
                "State names must be unique!")
        if self.params["verbose"]:
            print(f"Adding state {state.name}")
        self.states[state.name] = state
        self._spec = None

    def add_reaction(self, reaction: Reaction):
        assert isinstance(reaction, Reaction), \
            "reaction must be a pycatkin_tpu_torch Reaction"
        if self.params["verbose"]:
            print(f"Adding reaction {reaction.name}")
        self.reactions[reaction.name] = reaction
        self._spec = None

    def add_reactor(self, reactor: Reactor):
        assert isinstance(reactor, Reactor), \
            "reactor must be a pycatkin_tpu_torch Reactor"
        self.reactor = reactor
        self._spec = None

    def add_energy_landscape(self, energy_landscape: Energy):
        assert isinstance(energy_landscape, Energy)
        energy_landscape._system = self
        self.energy_landscapes[energy_landscape.name] = energy_landscape

    # ------------------------------------------------------------------
    # compilation
    def build(self, force: bool = False, strict: bool | None = None):
        """Compile the mechanism into the immutable ModelSpec. Idempotent;
        re-run after structural changes.

        ``strict`` controls the input-validation gate
        (:mod:`..frontend.validate`): True raises ``ValidationError`` on
        any validation error, False skips the gate, None follows the
        ``PYCATKIN_VALIDATE`` environment variable (strict|warn|off;
        default warn)."""
        need_build = self._spec is None or force
        if need_build or strict is not None:
            from ..frontend.validate import validate_system, validation_mode
            mode = (validation_mode() if strict is None
                    else ("strict" if strict else "off"))
            if mode != "off":
                validate_system(self).emit(mode)
        if need_build:
            rtype = self.reactor.reactor_type if self.reactor else None
            rparams = self.reactor.params() if self.reactor else None
            self._spec = build_spec(self.states, self.reactions,
                                    reactor=rtype, reactor_params=rparams,
                                    desorption_model=self.desorption_model)
        return self

    @property
    def spec(self):
        self.build()
        return self._spec

    @property
    def snames(self):
        return list(self.spec.snames)

    @property
    def adsorbate_indices(self):
        return list(self.spec.adsorbate_indices)

    @property
    def gas_indices(self):
        return list(self.spec.gas_indices)

    @property
    def dynamic_indices(self):
        return list(self.spec.dynamic_indices)

    @property
    def initial_system(self):
        return np.asarray(self.conditions().y0)

    def device_spec(self) -> engine.DeviceSpec:
        """The spec bound to :attr:`device` (rebound after a rebuild)."""
        spec = self.spec
        if self._ds is None or self._ds.host is not spec:
            self._ds = engine.bind(spec, self.device)
        return self._ds

    def conditions(self, T=None, p=None, kscale=None,
                   eps_extra: dict | None = None) -> Conditions:
        """Snapshot the current host-side model state into one point's
        :class:`Conditions` (numpy): the possibly user-mutated State.Gelec
        values, user reaction energies and energy modifiers."""
        spec = self.spec
        T = self.params["temperature"] if T is None else T
        p = self.params["pressure"] if p is None else p
        gelec_overrides = {name: st.Gelec for name, st in self.states.items()
                           if st.Gelec is not None}
        eps = {name: st.add_to_energy for name, st in self.states.items()
               if st.add_to_energy}
        if eps_extra:
            for name, val in eps_extra.items():
                eps[name] = eps.get(name, 0.0) + val
        return default_conditions(
            spec, self.reactions, T=T, p=p,
            start_state=self.params.get("start_state"),
            inflow_state=self.params.get("inflow_state"),
            gelec_overrides=gelec_overrides, eps=eps, kscale=kscale)

    def lane(self, cond: Conditions | None = None) -> Conditions:
        """``cond`` (default: :meth:`conditions`) as a one-lane batch on
        :attr:`device`."""
        cond = self.conditions() if cond is None else cond
        if isinstance(cond.T, torch.Tensor):
            return cond if cond.T.dim() else Conditions(
                *(f[None] for f in cond))
        return engine.conditions_to(broadcast_conditions(cond, 1),
                                    self.device)

    def _state(self, y):
        return torch.as_tensor(np.asarray(_host(y), dtype=np.float64),
                               device=self.device)[None]

    # ------------------------------------------------------------------
    # point evaluations
    def free_energy_table(self, T=None, p=None) -> engine.FreeEnergies:
        """Every species' electronic and free energies and contributions
        at (T, p), as numpy arrays ``[n_s]``; also written back onto the
        State objects (``state.Gfree_computed`` etc.)."""
        fe = engine.free_energies(self.device_spec(),
                                  self.lane(self.conditions(T=T, p=p)))
        fe = engine.FreeEnergies(*(_host(f[0]) for f in fe))
        for i, name in enumerate(self.spec.snames):
            # Energy-only donor species have no entry in self.states.
            if name not in self.states:
                continue
            st = self.states[name]
            st.Gelec_computed = float(fe.gelec[i])
            if not st.is_scaling and st.Gelec is None:
                st.Gelec = float(fe.gelec[i])
            st.Gvibr_computed = float(fe.gvibr[i])
            st.Gtran_computed = float(fe.gtran[i])
            st.Grota_computed = float(fe.grota[i])
            st.Gfree_computed = float(fe.gfree[i])
        return fe

    def reaction_energy_table(self, T=None, p=None) -> engine.ReactionEnergies:
        re = engine.reaction_energies(self.device_spec(),
                                      self.lane(self.conditions(T=T, p=p)))
        return engine.ReactionEnergies(*(_host(f[0]) for f in re))

    def rate_constant_table(self, T=None, p=None):
        kf, kr, keq = engine.rate_constants(
            self.device_spec(), self.lane(self.conditions(T=T, p=p)))
        return _host(kf[0]), _host(kr[0]), _host(keq[0])

    def get_dydt(self, y, cond: Conditions | None = None):
        return _host(engine.get_dydt(self.device_spec(), self.lane(cond),
                                     self._state(y))[0])

    species_odes = get_dydt

    def get_jacobian(self, y, cond: Conditions | None = None):
        return _host(engine.get_jacobian(self.device_spec(), self.lane(cond),
                                         self._state(y))[0])

    species_jacobian = get_jacobian

    def reaction_terms(self, y, cond: Conditions | None = None):
        """``[n_r, 2]`` forward and reverse rates at ``y``; also stored on
        ``self.rates``."""
        fwd, rev = engine.reaction_rates_at(self.device_spec(),
                                            self.lane(cond), self._state(y))
        self.rates = np.stack([_host(fwd[0]), _host(rev[0])], axis=1)
        return self.rates

    # ------------------------------------------------------------------
    # solvers
    def _ode_options(self) -> ODEOptions:
        opts = ODEOptions(rtol=self.params["rtol"],
                          atol=self.params["atol"])
        if self.params["ode_solver"] == "esdirk4":
            opts = opts._replace(method="esdirk4")
        # The legacy default (1e4) maps onto the native default budget;
        # an explicitly tuned nsteps becomes the per-interval step cap.
        if int(self.params["nsteps"]) != 10000:
            opts = opts._replace(max_steps=int(self.params["nsteps"]))
        return opts

    def solver_options(self, **overrides) -> SolverOptions:
        base = SolverOptions(floor=self.min_tol,
                             rate_tol=min(float(self.params["ftol"]),
                                          float(self.params["xtol"])))
        return base._replace(**overrides) if overrides else base

    def solve_odes(self, n_out=None, times=None):
        """Transient integration over the configured time span on a
        log-spaced output grid, one lane of ``engine.transient`` (the
        integration, then the Newton finish). Stores ``self.times`` and
        ``self.solution`` (numpy ``[t, n_s]``)."""
        times = times if times is not None else self.params["times"]
        assert times is not None, "System times are not set"
        n_out = n_out or self.params.get("n_out", 300)
        grid = log_time_grid(times[0], times[-1], n_out)
        ys, ok = engine.transient(self.device_spec(), self.lane(), grid,
                                  self._ode_options())
        self.times = grid
        self.solution = _host(ys[0])
        if not bool(ok[0]):
            print("Warning: transient integration did not complete cleanly")
        if self.params["verbose"]:
            print("Final state:", dict(zip(self.spec.snames,
                                           self.solution[-1])))
        return self.solution

    def find_steady(self, store_steady=False, y0=None,
                    use_transient_guess=True, key=None,
                    opts: SolverOptions | None = None,
                    check_stability=True,
                    pos_jac_tol=1e-2) -> SteadyStateResults:
        """Steady-state solve. Initial guess: an explicit ``y0``, else the
        transient tail (integrating first when a time span is set and no
        transient is stored), else the start state. A failed PTC solve is
        re-solved by projected LM from its best iterate. With
        ``check_stability``, a converged state whose Jacobian has an
        eigenvalue with real part above ``pos_jac_tol`` is replaced by up
        to three re-solves from random restarts (keys split from ``key``,
        by default ``prng_key(1)``); if none is stable the result reports
        ``success=False``. ``key``: one PRNG key ``[2]``. Returns one
        lane's :class:`SteadyStateResults` (0-d tensors, ``x [n_s]``)."""
        ds = self.device_spec()
        cond = self.lane()
        solver_opts = opts or self.solver_options()
        dyn = self.spec.dynamic_indices
        keys = None if key is None else torch.as_tensor(
            key, device=ds.device)[None]
        x0 = None
        if y0 is not None:
            x0 = np.asarray(_host(y0))[dyn]
        elif use_transient_guess:
            times = self.params.get("times")
            if (self.solution is None and times is not None
                    and len(times) > 0):
                # The physically meaningful root of a multistable network
                # is the t -> inf limit of the start state.
                self.solve_odes()
            if self.solution is not None:
                x0 = self.solution[-1][dyn]
        x0 = None if x0 is None else self._state(x0)
        res = engine.steady_state(ds, cond, x0=x0, key=keys,
                                  opts=solver_opts)
        if not bool(res.success[0]):
            lm = engine.steady_state(ds, cond, x0=res.x[:, ds.dyn],
                                     key=keys, opts=solver_opts,
                                     strategy="lm")
            if bool(lm.success[0]):
                res = lm
        if check_stability and bool(res.success[0]):
            k = (torch.as_tensor(key, device=ds.device) if key is not None
                 else prng.prng_key(1, ds.device))
            stable = bool(engine.check_stability(ds, cond, res.x,
                                                 pos_tol=pos_jac_tol)[0])
            for _ in range(3):
                if stable:
                    break
                # Converged onto an unstable branch: restart from a fresh
                # random guess.
                k, sub = prng.split(k)
                retry = engine.steady_state(ds, cond, key=sub[None],
                                            opts=solver_opts)
                if bool(retry.success[0]):
                    res = retry
                    stable = bool(engine.check_stability(
                        ds, cond, res.x, pos_tol=pos_jac_tol)[0])
            if not stable:
                res = res._replace(success=torch.zeros_like(res.success))
        res = SteadyStateResults(*(None if f is None else f[0] for f in res))
        self.steady_result = res
        self.full_steady = _host(res.x)
        if self.params["verbose"]:
            print(f"Steady state: success={bool(res.success)} "
                  f"residual={float(res.residual):.3g} "
                  f"iters={int(res.iterations)}")
        return res

    # ------------------------------------------------------------------
    # derived analyses
    def run_and_return_tof(self, tof_terms, ss_solve=False):
        if ss_solve:
            self.find_steady()
            y = self.full_steady
        else:
            self.solve_odes()
            y = self.solution[-1]
        cond = self.lane()
        mask = torch.as_tensor(engine.tof_mask_for(self.spec, tof_terms),
                               dtype=torch.float64, device=self.device)
        self.reaction_terms(y, cond)
        return float(engine.tof(self.device_spec(), cond, self._state(y),
                                mask)[0])

    def degree_of_rate_control(self, tof_terms, ss_solve=True, eps=1.0e-3,
                               mode="implicit"):
        """Degree of rate control of every reaction (a dict by name), from
        the last transient state. ``mode='implicit'``: the adjoint through
        the steady solve (:func:`engine.drc`); ``mode='fd'``: batched
        central differences (:func:`engine.drc_fd`)."""
        if self.solution is None:
            self.solve_odes()
        ds = self.device_spec()
        cond = self.lane()
        x0 = self._state(self.solution[-1][self.spec.dynamic_indices])
        if mode == "implicit":
            xi = engine.drc(ds, cond, tof_terms, x0=x0,
                            opts=self.solver_options())
        else:
            xi, ok = engine.drc_fd(ds, cond, tof_terms, eps=eps, x0=x0)
            if not bool(ok[0]):
                warnings.warn(
                    "finite-difference DRC: not all perturbed steady "
                    "solves converged; values may be unreliable (prefer "
                    "mode='implicit')", stacklevel=2)
        return dict(zip(self.spec.rnames, _host(xi[0])))

    def activity(self, tof_terms, ss_solve=False):
        tof_val = self.run_and_return_tof(tof_terms, ss_solve=ss_solve)
        if tof_val <= 0.0:
            warnings.warn(
                f"activity: net TOF of {tof_terms} is non-positive "
                f"({tof_val:.3e}); the selected steps run in reverse at "
                "the solution. Reporting the activity of |TOF|.",
                stacklevel=2)
        T = torch.tensor(float(self.params["temperature"]),
                         dtype=torch.float64)
        return float(engine.activity_from_tof(
            torch.tensor(tof_val, dtype=torch.float64), T))

    # ------------------------------------------------------------------
    def copy(self) -> "System":
        ds, self._ds = self._ds, None
        try:
            new = copy.deepcopy(self)
        finally:
            self._ds = ds
        new._spec = None
        return new
