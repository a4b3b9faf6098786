"""Host-side species description (numpy only).

A :class:`State` is a data resolver: it loads electronic energies,
vibrational frequencies, masses and moments of inertia from DFT artifacts
(OUTCAR, ``log.vib``, ``.dat`` files, through :mod:`.parsers`) or takes
them from the input file or from memory, and exposes them to the spec
compiler (:func:`pycatkin_tpu_torch.frontend.spec.build_spec`). It does
no thermochemistry: that lives in :mod:`pycatkin_tpu_torch.ops.thermo`.

A copy of ``pycatkin_tpu/frontend/states.py``: state types
(gas/adsorbate/surface/TS), energy and frequency sources, the frequency
floor and DOF padding rules, mode-truncation counts, gas shape
detection, gas mixtures (``gasdata``), energy modifiers and linear
scaling relations (``dereference``, ``use_descriptor_as_reactant``).
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import parsers

GAS = "gas"
ADSORBATE = "adsorbate"
SURFACE = "surface"
TS = "TS"

STATE_TYPES = (GAS, ADSORBATE, SURFACE, TS)

# Moments of inertia below this (amu*A^2) are treated as numerically zero
# when detecting linear molecules (reference state.py:69,99).
INERTIA_CUTOFF = 1.0e-12

# State names already warned about degenerate inertia tensors (the
# warning fires once per process per state, not once per rebuild).
_ZERO_INERTIA_WARNED: set = set()

# CPK/jmol-ish element colors + covalent-radius-ish sizes for the
# headless structure render (State.save_png). Unlisted elements fall
# back to gray / 1.2 A.
ELEMENT_COLORS = {
    "H": "#f2f2f2", "C": "#555555", "N": "#3050f8", "O": "#ff0d0d",
    "F": "#90e050", "Al": "#bfa6a6", "Si": "#f0c8a0", "P": "#ff8000",
    "S": "#ffff30", "Cl": "#1ff01f", "Ti": "#bfc2c7", "Fe": "#e06633",
    "Co": "#f090a0", "Ni": "#50d050", "Cu": "#c88033", "Zn": "#7d80b0",
    "Pd": "#006985", "Ag": "#c0c0c0", "Pt": "#d0d0e0", "Au": "#ffd123",
}
ELEMENT_RADII = {
    "H": 0.4, "C": 0.75, "N": 0.72, "O": 0.7, "F": 0.6, "Al": 1.2,
    "Si": 1.1, "P": 1.05, "S": 1.0, "Cl": 1.0, "Ti": 1.5, "Fe": 1.35,
    "Co": 1.3, "Ni": 1.25, "Cu": 1.3, "Zn": 1.25, "Pd": 1.4, "Ag": 1.45,
    "Pt": 1.4, "Au": 1.4,
}


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
    read_from_alternate: Optional[dict] = None

    # Resolved lazily:
    shape: Optional[int] = field(default=None, repr=False)
    _loaded: bool = field(default=False, repr=False)

    def __post_init__(self):
        if self.state_type not in STATE_TYPES and self.state_type is not None:
            raise ValueError(
                f"state {self.name}: unknown state_type {self.state_type!r}")
        # Fixed-value thermo contributions supplied directly in the input
        # file short-circuit the corresponding kernel (reference
        # state.py:52-55 "inputfile" sources).
        self.tran_source = None if self.Gtran is None else "inputfile"
        self.rota_source = None if self.Grota is None else "inputfile"
        self.vibr_source = None if self.Gvibr is None else "inputfile"
        self.free_source = None if self.Gfree is None else "inputfile"
        if self.freq is not None:
            self.freq_source = "inputfile"
            self.freq = np.array(sorted(self.freq, reverse=True), dtype=float)
            self.i_freq = (np.array(sorted(self.i_freq, reverse=True), dtype=float)
                           if self.i_freq is not None else np.array([]))
        if self.inertia is not None:
            self._set_inertia(np.asarray(self.inertia, dtype=float))
        if self.state_type == GAS and self.sigma is None:
            raise ValueError(f"gas state {self.name} requires a symmetry number")

    # ------------------------------------------------------------------
    # construction from in-memory structure objects
    @classmethod
    def from_atoms(cls, name: str, atoms, state_type: str,
                   sigma: Optional[float] = None, freq=None, i_freq=None,
                   energy: Optional[float] = None, **kwargs) -> "State":
        """Build a State from an in-memory ASE ``Atoms``(-like) object.

        The reference reads structures through ASE and holds ``Atoms``
        objects directly (reference state.py:77-105: ``get_atoms``
        computes mass/inertia via ``atoms.get_masses()`` /
        ``atoms.get_moments_of_inertia()``); this is the entry point for
        users who already hold such an object instead of an
        OUTCAR/log.vib tree. ASE itself is NOT required (and is not a
        dependency): any object exposing ``get_masses()`` and -- for gas
        states -- ``get_moments_of_inertia()`` (amu*A^2) works. The
        electronic energy is taken from ``energy`` if given, else from
        ``atoms.get_potential_energy()`` when the object has a
        calculator attached (errors there are treated as "no energy",
        matching a bare structure file).

        ``freq``/``i_freq`` (Hz) seed the vibrational modes exactly like
        input-file frequencies. The structure (symbols + positions) is
        kept for :meth:`get_structure`/:meth:`save_pdb` when the object
        exposes ``get_chemical_symbols()``/``get_positions()``.
        """
        mass = float(np.sum(np.asarray(atoms.get_masses(), dtype=float)))
        inertia = None
        if state_type == GAS:
            inertia = np.asarray(atoms.get_moments_of_inertia(),
                                 dtype=float)
        if energy is None and hasattr(atoms, "get_potential_energy"):
            try:
                energy = float(atoms.get_potential_energy())
            except Exception:      # no calculator attached -> no energy
                energy = None
        st = cls(name=name, state_type=state_type, sigma=sigma,
                 mass=mass, inertia=inertia, freq=freq, i_freq=i_freq,
                 Gelec=energy, **kwargs)
        if (hasattr(atoms, "get_chemical_symbols")
                and hasattr(atoms, "get_positions")):
            st._structure = (list(atoms.get_chemical_symbols()),
                             np.asarray(atoms.get_positions(),
                                        dtype=float))
        return st

    # ------------------------------------------------------------------
    # data resolution
    def _set_inertia(self, inertia: np.ndarray):
        inertia = np.where(inertia > INERTIA_CUTOFF, inertia, 0.0)
        self.inertia = inertia
        self.shape = int((inertia > 0.0).sum())
        if (self.state_type == GAS and self.shape < 2
                and self.name not in _ZERO_INERTIA_WARNED):
            # Warn once per process per state: every rebuild/sweep setup
            # re-derives the same inertia tensor, and repeating the
            # warning per rebuild buries real diagnostics in the log.
            _ZERO_INERTIA_WARNED.add(self.name)
            print(f"state {self.name}: too many zero moments of inertia",
                  file=sys.stderr)

    def load(self, verbose: bool = False):
        """Resolve electronic energy, frequencies and geometry from sources."""
        if self._loaded:
            return self
        self._load_structure(verbose)
        self._load_frequencies(verbose)
        self._load_energy(verbose)
        self._loaded = True
        return self

    def _load_structure(self, verbose: bool):
        needs_geometry = (self.state_type == GAS and
                          (self.mass is None or self.inertia is None))
        if not needs_geometry:
            return
        if self.read_from_alternate and "get_atoms" in self.read_from_alternate:
            _, self.mass, inertia = self.read_from_alternate["get_atoms"]()
            self._set_inertia(np.asarray(inertia, dtype=float))
            return
        if self.path is None:
            if self.mass is None:
                raise ValueError(
                    f"gas state {self.name}: no mass and no path to read it")
            # Mass given but no inertia source: rotational contributions
            # are unavailable (engine returns 0 for them). Legitimate for
            # species whose free energy never enters the model (e.g.
            # user-defined reaction members, COOxVolcano CO/O2/CO2).
            self._set_inertia(np.zeros(3))
            return
        data = parsers.read_outcar(parsers.resolve_outcar_path(self.path))
        if self.mass is None:
            self.mass = data["mass"]
        if self.inertia is None:
            self._set_inertia(data["inertia"])

    def _load_frequencies(self, verbose: bool):
        if self.freq is not None or self.vibr_source == "inputfile":
            return
        if self.freq_source == "datafile":
            freq, i_freq = parsers.read_frequency_dat(self.vibs_path)
            self.freq = np.array(sorted(freq, reverse=True))
            self.i_freq = np.asarray(i_freq)
            return
        freq = i_freq = None
        if self.read_from_alternate and "get_vibrations" in self.read_from_alternate:
            freq, i_freq = self.read_from_alternate["get_vibrations"]()
        if not freq:
            base = self.vibs_path if self.vibs_path is not None else self.path
            if base is None:
                self.freq = np.zeros(0)
                self.i_freq = np.zeros(0)
                return
            log_vib = os.path.join(base, "log.vib")
            if os.path.isfile(log_vib):
                freq, i_freq = parsers.read_log_vib(log_vib)
            else:
                freq, i_freq = parsers.read_outcar_frequencies(
                    parsers.resolve_outcar_path(self.path))
        if self.truncate_freq:
            if self.state_type == GAS and self.shape is None:
                self._load_structure(verbose)
            freq = parsers.apply_frequency_floor(
                list(freq), list(i_freq), self.state_type, verbose)
        self.freq = np.array(sorted(freq, reverse=True))
        self.i_freq = np.asarray(list(i_freq), dtype=float)

    def _load_energy(self, verbose: bool):
        if self.Gelec is not None:
            return
        if self.energy_source == "datafile":
            self.Gelec = parsers.read_energy_dat(self.path)
            return
        if (self.read_from_alternate and
                "get_electronic_energy" in self.read_from_alternate):
            self.Gelec = self.read_from_alternate["get_electronic_energy"]()
            return
        if self.path is not None:
            data = parsers.read_outcar(parsers.resolve_outcar_path(self.path))
            self.Gelec = data["energy"]
        # else: stays None -- scaling states and runtime-overridden
        # descriptor states resolve their Gelec elsewhere.

    # ------------------------------------------------------------------
    # spec inputs
    @property
    def n_truncate(self) -> int:
        """Number of highest-index (smallest) modes dropped from vibrational
        sums: gas drops ``shape`` rotational placeholders, a TS without an
        identified imaginary mode drops one (reference state.py:276-283)."""
        if self.state_type == GAS:
            return int(self.shape or 0)
        if self.state_type == TS and (self.i_freq is None or len(self.i_freq) == 0):
            return 1
        return 0

    def used_frequencies(self) -> np.ndarray:
        """Frequencies (Hz, descending) that enter ZPE/vibrational sums."""
        self.load()
        if self.freq is None or self.freq.size == 0:
            return np.zeros(0)
        nfreqs = self.freq.shape[0] - self.n_truncate
        return self.freq[:max(nfreqs, 0)]

    def set_energy_modifier(self, modifier):
        self.add_to_energy = modifier

    def get_structure(self):
        """(symbols, positions [A]) of the final ionic step, read from the
        state's OUTCAR (or kept from :meth:`from_atoms`). None when the
        state has no structure source."""
        if getattr(self, "_structure", None) is not None:
            return self._structure
        if self.path is None:
            return None
        try:
            outcar = parsers.resolve_outcar_path(self.path)
            data = parsers.read_outcar(outcar)
        except (OSError, ValueError):
            return None
        return data["symbols"], data["positions"]

    def save_pdb(self, path: str = ""):
        """Write the state's structure as a .pdb file (reference
        state.py:413-434 via ase.io.write; native minimal writer here).
        Returns the file path, or None when no structure is available."""
        struct = self.get_structure()
        if struct is None:
            return None
        symbols, positions = struct
        import os
        if path:
            os.makedirs(path, exist_ok=True)
        fname = os.path.join(path, f"{self.name}.pdb")
        with open(fname, "w") as fh:
            fh.write(f"TITLE     {self.name}\n")
            for i, (sym, (x, y, z)) in enumerate(zip(symbols, positions),
                                                 start=1):
                # Fixed columns per the PDB spec: serial 7-11, name
                # 13-16, altLoc 17, resName 18-20, chain 22, resSeq
                # 23-26, x/y/z 31-54, occupancy 55-60, tempFactor
                # 61-66, element 77-78 (right-justified, so two-letter
                # species like Pd survive strict readers).
                fh.write(
                    f"HETATM{i:>5d} {sym:<4s} MOL A{1:>4d}    "
                    f"{x:8.3f}{y:8.3f}{z:8.3f}{1.0:6.2f}{0.0:6.2f}"
                    f"          {sym:>2s}\n")
            fh.write("END\n")
        return fname

    def save_png(self, path: str = ""):
        """Headless .png render of the state's structure (parity with
        the reference's ``view_atoms`` image export, state.py:444-463,
        which writes .png through ASE's renderer; the interactive viewer
        has no headless counterpart). Matplotlib 3D scatter with CPK-ish
        element colors, atoms depth-sorted and sized by covalent radius.
        Returns the file path, or None when no structure is available."""
        struct = self.get_structure()
        if struct is None:
            return None
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        symbols, positions = struct
        pos = np.asarray(positions, dtype=float)
        colors = [ELEMENT_COLORS.get(s, "#909090") for s in symbols]
        radii = np.array([ELEMENT_RADII.get(s, 1.2) for s in symbols])
        fig = plt.figure(figsize=(4.5, 4.5))
        ax = fig.add_subplot(projection="3d")
        ax.scatter(pos[:, 0], pos[:, 1], pos[:, 2], c=colors,
                   s=(radii * 18.0) ** 2, edgecolors="black",
                   linewidths=0.4, depthshade=True)
        # Equal aspect so slabs don't look sheared.
        spans = pos.max(axis=0) - pos.min(axis=0)
        mids = (pos.max(axis=0) + pos.min(axis=0)) / 2.0
        half = max(float(spans.max()) / 2.0, 1.0)
        ax.set_xlim(mids[0] - half, mids[0] + half)
        ax.set_ylim(mids[1] - half, mids[1] + half)
        ax.set_zlim(mids[2] - half, mids[2] + half)
        ax.set_axis_off()
        ax.set_title(self.name)
        if path:
            os.makedirs(path, exist_ok=True)
        fname = os.path.join(path, f"{self.name}.png")
        fig.savefig(fname, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return fname

    @property
    def is_scaling(self) -> bool:
        return False


@dataclass
class ScalingState(State):
    """Species whose electronic energy is a linear scaling relation over
    descriptor reaction energies (reference state.py:466-565).

    ``Gelec = intercept + sum_i multiplicity_i * gradient_i * dE_i`` with
    ``dE_i`` the electronic energy of descriptor reaction i. With
    ``dereference``, each term adds the descriptor reaction's summed
    reactant electronic energies. With ``use_descriptor_as_reactant``, the
    free energy is assembled from descriptor reaction free/electronic
    energies instead of this state's own partition functions.
    """

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

    def _load_energy(self, verbose: bool):
        # Electronic energy comes from the scaling relation at engine time.
        pass

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
