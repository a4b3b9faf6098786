"""Host-side parsers for DFT artifacts (numpy only).

A copy of ``pycatkin_tpu/frontend/parsers.py`` (the port keeps its own
and imports nothing of the JAX package). OUTCAR, ``.dat`` and
``log.vib`` files are parsed natively, without ASE. Output conventions
match upstream PyCatKin:

- energies in eV (VASP ``free  energy   TOTEN``, force-consistent)
- frequencies in Hz
- masses in amu (standard atomic weights, as ASE's defaults)
- moments of inertia in amu*A^2, principal values sorted ascending
"""

from __future__ import annotations

import os
import re

import numpy as np

from ..constants import FREQ_FLOOR_HZ, JtoeV, h

# Standard atomic weights (IUPAC abridged), indexed by symbol. These are the
# same defaults ASE assigns to Atoms objects, which the reference relies on
# for total masses and moments of inertia.
ATOMIC_MASSES = {
    "H": 1.008, "He": 4.002602, "Li": 6.94, "Be": 9.0121831, "B": 10.81,
    "C": 12.011, "N": 14.007, "O": 15.999, "F": 18.998403163, "Ne": 20.1797,
    "Na": 22.98976928, "Mg": 24.305, "Al": 26.9815385, "Si": 28.085,
    "P": 30.973761998, "S": 32.06, "Cl": 35.45, "Ar": 39.948, "K": 39.0983,
    "Ca": 40.078, "Sc": 44.955908, "Ti": 47.867, "V": 50.9415, "Cr": 51.9961,
    "Mn": 54.938044, "Fe": 55.845, "Co": 58.933194, "Ni": 58.6934,
    "Cu": 63.546, "Zn": 65.38, "Ga": 69.723, "Ge": 72.630, "As": 74.921595,
    "Se": 78.971, "Br": 79.904, "Kr": 83.798, "Rb": 85.4678, "Sr": 87.62,
    "Y": 88.90584, "Zr": 91.224, "Nb": 92.90637, "Mo": 95.95, "Tc": 97.90721,
    "Ru": 101.07, "Rh": 102.90550, "Pd": 106.42, "Ag": 107.8682,
    "Cd": 112.414, "In": 114.818, "Sn": 118.710, "Sb": 121.760, "Te": 127.60,
    "I": 126.90447, "Xe": 131.293, "Cs": 132.90545196, "Ba": 137.327,
    "La": 138.90547, "Ce": 140.116, "Pr": 140.90766, "Nd": 144.242,
    "Sm": 150.36, "Eu": 151.964, "Gd": 157.25, "Tb": 158.92535,
    "Dy": 162.500, "Ho": 164.93033, "Er": 167.259, "Tm": 168.93422,
    "Yb": 173.054, "Lu": 174.9668, "Hf": 178.49, "Ta": 180.94788,
    "W": 183.84, "Re": 186.207, "Os": 190.23, "Ir": 192.217, "Pt": 195.084,
    "Au": 196.966569, "Hg": 200.592, "Tl": 204.38, "Pb": 207.2,
    "Bi": 208.98040, "Th": 232.0377, "U": 238.02891,
}


def read_energy_dat(path: str) -> float:
    """Read an electronic energy in eV from a one-line ``*_energy.dat`` file.

    Format: ``<float> eV`` (reference state.py:253-256).
    """
    with open(path) as fh:
        first = fh.readlines()[0]
    return float(first.split("eV")[0])


def read_frequency_dat(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Read real/imaginary frequencies (Hz) from a ``*_frequencies.dat`` file.

    Lines look like ``0 f = 7.05e12 Hz`` (real) or ``3 f/i = ... Hz``
    (imaginary); a '/' marks imaginary modes (reference state.py:112-120).
    """
    freq, i_freq = [], []
    with open(path) as fh:
        for line in fh:
            if "=" not in line or "Hz" not in line:
                continue
            value = float(line.split("=")[1].split("Hz")[0])
            (i_freq if "/" in line else freq).append(value)
    return np.asarray(freq, dtype=float), np.asarray(i_freq, dtype=float)


def read_log_vib(path: str) -> tuple[list[float], list[float]]:
    """Parse an ASE vibration summary (``log.vib``) into Hz.

    The table's meV column is converted via f = meV*1e-3/(h*JtoeV); entries
    containing 'i' are imaginary modes (reference state.py:137-156).
    """
    with open(path) as fh:
        lines = fh.readlines()
    initat = 0
    endat = 0
    for lind, line in enumerate(lines):
        if "#" in line:
            initat = lind + 2
            endat = 0
        if lind > initat and not endat and "---" in line:
            endat = lind - 1
    freq = [float(line.strip().split()[1]) * 1e-3 / (h * JtoeV)
            for line in lines[initat:endat + 1] if "i" not in line]
    i_freq = [float(line.strip().split()[1].split("i")[0]) * 1e-3 / (h * JtoeV)
              for line in lines[initat:endat + 1] if "i" in line]
    return freq, i_freq


_POTCAR_RE = re.compile(r"^\s*POTCAR:\s+\S+\s+(\S+)")


def _outcar_symbols(lines: list[str]) -> list[str]:
    """Extract the per-atom chemical symbols from OUTCAR header lines."""
    species: list[str] = []
    counts: list[int] = []
    for line in lines:
        m = _POTCAR_RE.match(line)
        if m:
            sym = m.group(1).split("_")[0]
            species.append(sym)
        if "ions per type" in line:
            counts = [int(tok) for tok in line.split("=")[1].split()]
            break
    # The POTCAR header block lists each pseudopotential twice (once in the
    # summary, once per-species detail); keep the first n_types entries.
    if counts:
        species = species[: len(counts)]
    symbols: list[str] = []
    for sym, cnt in zip(species, counts):
        symbols += [sym] * cnt
    return symbols


def read_outcar(path: str) -> dict:
    """Parse a VASP OUTCAR: final force-consistent energy, masses, geometry.

    Mirrors what the reference obtains through
    ``ase.io.read(..., format='vasp-out')`` + ``get_potential_energy
    (force_consistent=True)`` + ``get_masses`` + ``get_moments_of_inertia``
    (reference state.py:77-105).

    Returns dict with keys: energy (eV), symbols, masses (amu per atom),
    mass (total amu), positions (A, final ionic step), inertia
    (principal moments, amu*A^2, ascending).
    """
    with open(path) as fh:
        lines = fh.readlines()

    symbols = _outcar_symbols(lines)
    masses = np.array([ATOMIC_MASSES[s] for s in symbols], dtype=float)

    energy = None
    positions = None
    i = 0
    n = len(lines)
    while i < n:
        line = lines[i]
        if "free  energy   TOTEN" in line or "free energy    TOTEN" in line:
            energy = float(line.split("=")[1].split("eV")[0])
        if line.lstrip().startswith("POSITION"):
            block = []
            j = i + 2
            while j < n and "----" not in lines[j]:
                toks = lines[j].split()
                if len(toks) >= 3:
                    block.append([float(t) for t in toks[:3]])
                j += 1
            positions = np.asarray(block, dtype=float)
            i = j
        i += 1

    if energy is None:
        raise ValueError(f"No TOTEN energy found in OUTCAR: {path}")
    if positions is None or len(positions) != len(symbols):
        raise ValueError(f"Could not read final positions from OUTCAR: {path}")

    return {
        "energy": energy,
        "symbols": symbols,
        "masses": masses,
        "mass": float(masses.sum()),
        "positions": positions,
        "inertia": moments_of_inertia(positions, masses),
    }


def moments_of_inertia(positions: np.ndarray, masses: np.ndarray) -> np.ndarray:
    """Principal moments of inertia (amu*A^2) about the center of mass.

    Eigenvalues sorted ascending, matching ASE's
    ``Atoms.get_moments_of_inertia``.
    """
    com = (masses[:, None] * positions).sum(axis=0) / masses.sum()
    rel = positions - com
    x, y, z = rel[:, 0], rel[:, 1], rel[:, 2]
    ixx = (masses * (y**2 + z**2)).sum()
    iyy = (masses * (x**2 + z**2)).sum()
    izz = (masses * (x**2 + y**2)).sum()
    ixy = -(masses * x * y).sum()
    ixz = -(masses * x * z).sum()
    iyz = -(masses * y * z).sum()
    tensor = np.array([[ixx, ixy, ixz], [ixy, iyy, iyz], [ixz, iyz, izz]])
    return np.linalg.eigvalsh(tensor)


def read_outcar_frequencies(path: str) -> tuple[list[float], list[float]]:
    """Parse vibrational frequencies (Hz) from OUTCAR ``THz`` lines.

    Keeps only the first copy of the frequency table (VASP repeats it), as
    the reference does (state.py:158-182). Column -8 is the value in THz.
    """
    freq: list[float] = []
    i_freq: list[float] = []
    firstcopy = 0
    index = -8
    with open(path) as fh:
        for line in fh:
            data = line.split()
            if "THz" in data:
                if (firstcopy + 1) == int(data[0]):
                    f_hz = float(data[index]) * 1.0e12
                    if "f/i=" not in data and "f/i" not in data:
                        freq.append(f_hz)
                    else:
                        i_freq.append(f_hz)
                    firstcopy = int(data[0])
                else:
                    break
    return freq, i_freq


def apply_frequency_floor(freq: list[float], i_freq: list[float],
                          state_type: str | None,
                          verbose: bool = False) -> list[float]:
    """Floor small parsed frequencies at 12.4 meV and pad missing DOF.

    Applied ONLY to frequencies parsed from log.vib/OUTCAR, never to
    datafile/inputfile frequencies (reference state.py:183-203 runs in that
    branch only) -- golden numbers depend on this asymmetry.
    """
    freq = [FREQ_FLOOR_HZ if (f * h * JtoeV * 1e3) < 12.4 else f for f in freq]
    n_freq = len(freq)
    n_dof = len(freq) + len(i_freq)
    if state_type == "gas":
        n_dof -= 3
    if n_freq < n_dof:
        if verbose:
            print(f"Padding {n_dof - n_freq} frequencies at 12.4 meV")
        freq = freq + [FREQ_FLOOR_HZ] * (n_dof - n_freq)
    return freq


def resolve_outcar_path(path: str) -> str:
    """A state's ``path`` may be a directory containing OUTCAR or the file
    itself (reference state.py:88-91)."""
    cand = os.path.join(path, "OUTCAR")
    return cand if os.path.isfile(cand) else path
