"""Host-side species description (numpy only).

A :class:`State` holds the electronic energy, vibrational frequencies,
mass and moments of inertia of one species and exposes them to the spec
compiler (:func:`pycatkin_tpu_torch.frontend.spec.build_spec`). It does
no thermochemistry: that lives in :mod:`pycatkin_tpu_torch.ops.thermo`.

Port of ``pycatkin_tpu/frontend/states.py`` for in-memory sources (the
form every synthetic and programmatic mechanism uses): state types,
frequency ordering and mode-truncation counts, gas shape detection,
``gasdata`` mixtures, energy modifiers and linear scaling relations.
Reading DFT artifacts (OUTCAR, log.vib, ``.dat`` files) belongs to the
frontend slice of the port and raises ``NotImplementedError`` here.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

GAS = "gas"
ADSORBATE = "adsorbate"
SURFACE = "surface"
TS = "TS"

STATE_TYPES = (GAS, ADSORBATE, SURFACE, TS)

# Moments of inertia below this (amu*A^2) are treated as numerically zero
# when detecting linear molecules.
INERTIA_CUTOFF = 1.0e-12

# State names already warned about degenerate inertia tensors.
_ZERO_INERTIA_WARNED: set = set()

_FILE_SOURCES_TODO = ("reading DFT artifacts is not ported yet "
                      "(ROADMAP, Queue A: facade and frontend)")


@dataclass
class State:
    """One species: gas molecule, adsorbate, bare surface or transition state."""

    name: str
    state_type: str = None
    path: Optional[str] = None
    vibs_path: Optional[str] = None
    sigma: Optional[float] = None
    mass: Optional[float] = None
    inertia: Optional[np.ndarray] = None
    gasdata: Optional[dict] = None
    add_to_energy: Optional[float] = None
    truncate_freq: bool = True
    energy_source: Optional[str] = None
    freq_source: Optional[str] = None
    freq: Optional[np.ndarray] = None
    i_freq: Optional[np.ndarray] = None
    Gelec: Optional[float] = None
    Gzpe: Optional[float] = None
    Gvibr: Optional[float] = None
    Gtran: Optional[float] = None
    Grota: Optional[float] = None
    Gfree: Optional[float] = None

    # Resolved lazily:
    shape: Optional[int] = field(default=None, repr=False)
    _loaded: bool = field(default=False, repr=False)

    def __post_init__(self):
        if self.state_type not in STATE_TYPES and self.state_type is not None:
            raise ValueError(
                f"state {self.name}: unknown state_type {self.state_type!r}")
        self.vibr_source = None if self.Gvibr is None else "inputfile"
        if self.freq is not None:
            self.freq_source = "inputfile"
            self.freq = np.array(sorted(self.freq, reverse=True), dtype=float)
            self.i_freq = (np.array(sorted(self.i_freq, reverse=True),
                                    dtype=float)
                           if self.i_freq is not None else np.array([]))
        if self.inertia is not None:
            self._set_inertia(np.asarray(self.inertia, dtype=float))
        if self.state_type == GAS and self.sigma is None:
            raise ValueError(f"gas state {self.name} requires a symmetry number")

    def _set_inertia(self, inertia: np.ndarray):
        inertia = np.where(inertia > INERTIA_CUTOFF, inertia, 0.0)
        self.inertia = inertia
        self.shape = int((inertia > 0.0).sum())
        if (self.state_type == GAS and self.shape < 2
                and self.name not in _ZERO_INERTIA_WARNED):
            _ZERO_INERTIA_WARNED.add(self.name)
            print(f"state {self.name}: too many zero moments of inertia",
                  file=sys.stderr)

    def load(self, verbose: bool = False):
        """Resolve geometry and frequencies from the in-memory sources."""
        if self._loaded:
            return self
        if self.state_type == GAS and (self.mass is None
                                       or self.inertia is None):
            if self.path is not None:
                raise NotImplementedError(
                    f"state {self.name}: {_FILE_SOURCES_TODO}")
            if self.mass is None:
                raise ValueError(
                    f"gas state {self.name}: no mass and no path to read it")
            self._set_inertia(np.zeros(3))
        if self.freq is None and self.vibr_source != "inputfile":
            if (self.vibs_path or self.path
                    or self.freq_source == "datafile"):
                raise NotImplementedError(
                    f"state {self.name}: {_FILE_SOURCES_TODO}")
            self.freq = np.zeros(0)
            self.i_freq = np.zeros(0)
        if self.Gelec is None and not self.is_scaling and (
                self.path is not None or self.energy_source == "datafile"):
            raise NotImplementedError(
                f"state {self.name}: {_FILE_SOURCES_TODO}")
        self._loaded = True
        return self

    @property
    def n_truncate(self) -> int:
        """Number of highest-index (smallest) modes dropped from vibrational
        sums: gas drops ``shape`` rotational placeholders, a TS without an
        identified imaginary mode drops one."""
        if self.state_type == GAS:
            return int(self.shape or 0)
        if self.state_type == TS and (self.i_freq is None
                                      or len(self.i_freq) == 0):
            return 1
        return 0

    def used_frequencies(self) -> np.ndarray:
        """Frequencies (Hz, descending) that enter ZPE/vibrational sums."""
        self.load()
        if self.freq is None or self.freq.size == 0:
            return np.zeros(0)
        nfreqs = self.freq.shape[0] - self.n_truncate
        return self.freq[:max(nfreqs, 0)]

    @property
    def is_scaling(self) -> bool:
        return False


@dataclass
class ScalingState(State):
    """Species whose electronic energy is a linear scaling relation over
    descriptor reaction energies: ``Gelec = intercept + sum_i
    multiplicity_i * gradient_i * dE_i``. With ``dereference`` each term
    adds the descriptor reaction's summed reactant electronic energies;
    with ``use_descriptor_as_reactant`` the free energy is assembled from
    descriptor reaction energies instead of this state's own partition
    functions."""

    scaling_coeffs: Optional[dict] = None
    scaling_reactions: Optional[dict] = None
    dereference: bool = False
    use_descriptor_as_reactant: bool = False

    def __post_init__(self):
        super().__post_init__()
        if self.scaling_coeffs is None or self.scaling_reactions is None:
            raise ValueError(
                f"scaling state {self.name} needs scaling_coeffs and "
                "scaling_reactions")

    @property
    def is_scaling(self) -> bool:
        return True

    def gradients(self) -> list[float]:
        g = self.scaling_coeffs["gradient"]
        n = len(self.scaling_reactions)
        if np.isscalar(g):
            return [float(g)] * n
        g = list(g)
        if len(g) == 1:
            return [float(g[0])] * n
        assert len(g) == n, (
            f"scaling state {self.name}: {len(g)} gradients for {n} reactions")
        return [float(x) for x in g]

    def multiplicities(self) -> list[float]:
        return [float(r.get("multiplicity", 1.0))
                for r in self.scaling_reactions.values()]
