"""Uncertainty quantification: correlated-noise Monte Carlo over the
energy landscape (port of ``pycatkin_tpu/analysis/uncertainty.py``).

Per run, ONE Gaussian draw N(mu, sigma^2) is shared by every adsorbate
that appears in a reaction (a systematic DFT functional error moves all
binding energies together), and each transition state is perturbed by
that same draw scaled by an independent U(0,1) variate. The draws come
from ``np.random.default_rng(seed)`` in the JAX package's order, so the
ensemble is the same. The noise vectors are lanes of
``Conditions.eps``, and all runs (base + nruns) integrate as one
``batch_transient`` on the System's device.

``get_mean_property_value`` keeps the callback API (the property handle
receives a solved system-like object per run) while the solves
themselves stay batched.

As in the JAX package, the noise is ADDED on top of baseline
``add_to_energy`` modifiers (upstream PyCatKin overwrites them), so
systems that carry physical baseline modifiers keep them under UQ.
"""

from __future__ import annotations

import numpy as np

from ..frontend.reactions import ReactionDerivedReaction
from ..frontend.states import ADSORBATE, TS
from ..parallel.batch import batch_transient, stack_conditions
from ..solvers.ode import log_time_grid


class Uncertainty:

    def __init__(self, sys, mu: float = 0.0, sigma: float = 0.01,
                 nruns: int = 1, seed: int = 0):
        self.sys = sys.copy()
        self.mu = mu
        self.sigma = sigma
        self.nruns = nruns
        self.rng = np.random.default_rng(seed)
        self.noisy_sys = None
        self.state_noises = None

    # ------------------------------------------------------------------
    def _reaction_states(self):
        """(adsorbate names, TS names) reachable through reactions,
        following ReactionDerivedReaction energy borrowing."""
        ads, ts = [], []
        for rx in self.sys.reactions.values():
            base = (rx.base_reaction
                    if isinstance(rx, ReactionDerivedReaction) else rx)
            for s in list(base.reactants) + list(base.products):
                if s.state_type == ADSORBATE and s.name not in ads:
                    ads.append(s.name)
            for s in (base.TS or []):
                if s.name not in ts:
                    ts.append(s.name)
        return ads, ts

    def get_correlated_state_noises(self) -> dict:
        """One run's name -> noise map: shared Gaussian for adsorbates,
        Gaussian x U(0,1) per transition state."""
        noise = float(self.rng.normal(loc=self.mu, scale=self.sigma))
        ads, ts = self._reaction_states()
        noises = {name: noise for name in ads}
        for name in ts:
            noises[name] = noise * float(self.rng.uniform())
        return noises

    def noise_eps(self, state_noises: dict) -> np.ndarray:
        """Compile a name->noise map into an eps vector for Conditions."""
        spec = self.sys.spec
        eps = np.zeros(spec.n_species)
        for name, val in state_noises.items():
            eps[spec.sindex(name)] = val
        return eps

    # ------------------------------------------------------------------
    def get_noisy_sys_samples(self):
        """Solve base + nruns noisy transients as ONE lane batch.
        Populates self.noisy_sys (run -> solved system view) and
        self.state_noises."""
        sys = self.sys
        spec = sys.spec
        self.state_noises = {0: {}}
        conds = [sys.conditions()]
        for run in range(1, self.nruns + 1):
            noises = self.get_correlated_state_noises()
            self.state_noises[run] = noises
            conds.append(sys.conditions(
                eps_extra={k: v for k, v in noises.items()}))
        batched = stack_conditions(conds)

        times = sys.params["times"]
        grid = log_time_grid(times[0], times[-1],
                             sys.params.get("n_out", 300))
        ys, ok = batch_transient(spec, batched, grid, sys._ode_options(),
                                 device=sys.device)
        ys = ys.cpu().numpy()
        if not bool(ok.all()):
            print("Warning: some UQ transients did not integrate cleanly")

        self.noisy_sys = {}
        for run in range(self.nruns + 1):
            # Full copy with the run's noise applied as energy modifiers,
            # so property handles that recompute quantities (rates, TOF,
            # re-solves) see the same perturbed landscape the batched
            # solve used.
            view = sys.copy()
            for name, val in self.state_noises[run].items():
                st = view.states[name]
                st.set_energy_modifier((st.add_to_energy or 0.0) + val)
            view.times = grid
            view.solution = ys[run]
            view.full_steady = None
            self.noisy_sys[run] = view
        return self.noisy_sys

    def get_mean_property_value(self, property_handle):
        """(values, mean, std) of ``property_handle(sys)`` over the noisy
        ensemble; index 0 is the unperturbed base run, excluded from the
        statistics."""
        self.get_noisy_sys_samples()
        values = np.array([property_handle(self.noisy_sys[i])
                           for i in sorted(self.noisy_sys.keys())])
        return values, np.mean(values[1:]), np.std(values[1:])
