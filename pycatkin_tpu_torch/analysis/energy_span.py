"""Energy landscapes and the Kozuch-Shaik energy span model (port of
``pycatkin_tpu/analysis/energy_span.py``).

Relative free / electronic landscapes over ordered minima (each a list
of states summed) and the energy-span TOF estimate with TDTS/TDI
identification and degrees of TOF control. The numerical core
(:func:`energy_span_model`) works on a landscape ``[n]`` or on a batch
of them ``[L, n]``, on the device of its input.

Drawing utilities live in :mod:`pycatkin_tpu_torch.api.plotting`.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..constants import R, eVtokJ, h, kB

eVtoJmol = eVtokJ * 1.0e3


class EnergySpanResult(NamedTuple):
    tof: torch.Tensor         # turnover frequency [1/s]
    espan: torch.Tensor       # energy span [eV]
    i_tdts: torch.Tensor      # landscape index of the TOF-determining TS
    i_tdi: torch.Tensor       # landscape index of the TOF-determining interm.
    x_ts: torch.Tensor        # [n] degree of TOF control per TS entry
    x_int: torch.Tensor       # [n] degree of TOF control per intermediate
    eapp: torch.Tensor        # apparent activation energy [kJ/mol]
    drxn: torch.Tensor        # overall reaction free energy [J/mol]


def energy_span_model(vals, is_ts, T) -> EnergySpanResult:
    """Energy span model over a relative landscape.

    vals: ``[n]`` or ``[L, n]`` energies in eV relative to the first
    minimum; is_ts: ``[n]``, 1 for transition-state entries; T: a number
    or ``[L]``. The XTOF matrix couples every TS i with every
    intermediate j in (first, last) exclusive; when i >= j the overall
    reaction energy is subtracted (the cycle wraps). Every output has
    the leading shape of ``vals``.
    """
    vals = torch.as_tensor(vals, dtype=torch.float64)
    dev = vals.device
    is_ts = torch.as_tensor(is_ts, dtype=torch.float64, device=dev)
    T = torch.as_tensor(T, dtype=torch.float64, device=dev)
    n = vals.shape[-1]
    vj = vals * eVtoJmol
    drxn = vj[..., -1]
    idx = torch.arange(n, device=dev)
    row_ok = (is_ts > 0) & (idx <= n - 2)
    col_ok = (is_ts == 0) & (idx >= 1) & (idx <= n - 2)
    mask = row_ok[:, None] & col_ok[None, :]
    wrap = (idx[:, None] >= idx[None, :]).to(vj.dtype)
    X = vj[..., :, None] - vj[..., None, :] - wrap * drxn[..., None, None]
    RT = (R * T)[..., None, None]
    expX = torch.where(mask, torch.exp(X / RT), torch.zeros_like(X))
    den = torch.sum(expX, dim=(-2, -1))
    x_ts = torch.sum(expX, dim=-1) / den[..., None]
    x_int = torch.sum(expX, dim=-2) / den[..., None]
    i_tdts = torch.argmax(x_ts, dim=-1)
    i_tdi = torch.argmax(x_int, dim=-1)
    tof = (kB * T / h) * torch.exp((-drxn / (R * T)) - 1.0) / den
    espan = (torch.gather(vals, -1, i_tdts[..., None])
             - torch.gather(vals, -1, i_tdi[..., None]))[..., 0]
    eapp = torch.log(h * tof / (kB * T)) * (-R * T) * 1.0e-3
    return EnergySpanResult(tof=tof, espan=espan, i_tdts=i_tdts,
                            i_tdi=i_tdi, x_ts=x_ts, x_int=x_int,
                            eapp=eapp, drxn=drxn)


class Energy:
    """An ordered energy landscape built from lists of states.

    ``minima`` is a list of lists of State objects whose energies are
    summed per entry; an entry containing any TS-typed state is a
    transition-state entry.
    """

    def __init__(self, name="landscape", minima=None, labels=None):
        self.name = name
        self.minima = minima
        if labels is not None:
            self.labels = labels
        else:
            self.labels = [entry[0].name for entry in minima]
        assert len(self.labels) == len(self.minima)
        self.energy_landscape = None
        self._system = None  # set by System.add_energy_landscape

    # ------------------------------------------------------------------
    def entry_matrix(self, snames: Sequence[str]) -> np.ndarray:
        """[n_min, n_s] counts of each species in each landscape entry."""
        sindex = {n: i for i, n in enumerate(snames)}
        M = np.zeros((len(self.minima), len(snames)))
        for i, entry in enumerate(self.minima):
            for st in entry:
                M[i, sindex[st.name]] += 1.0
        return M

    @property
    def is_ts(self) -> np.ndarray:
        return np.array([1.0 if any(s.state_type == "TS" for s in entry)
                         else 0.0 for entry in self.minima])

    def construct_energy_landscape(self, T, p, verbose=False):
        """Relative free/electronic landscape at (T, p). Requires an
        owning System (for the engine)."""
        sys = self._system
        assert sys is not None, "Energy landscape is not attached to a System"
        fe = sys.free_energy_table(T=T, p=p)
        M = self.entry_matrix(sys.snames)
        free = M @ np.asarray(fe.gfree)
        elec = M @ np.asarray(fe.gelec)
        is_ts = self.is_ts
        self.energy_landscape = {
            "free": {i: float(v - free[0]) for i, v in enumerate(free)},
            "electronic": {i: float(v - elec[0]) for i, v in enumerate(elec)},
            "isTS": {i: int(t) for i, t in enumerate(is_ts)},
            "T": T, "p": p,
        }
        return self.energy_landscape

    def _landscape_vector(self, T, p, etype="free", verbose=False):
        # Always recompute: a (T, p)-keyed cache would serve stale
        # landscapes after descriptor/user-energy mutation.
        self.construct_energy_landscape(T=T, p=p, verbose=verbose)
        n = len(self.minima)
        return np.array([self.energy_landscape[etype][i] for i in range(n)])

    def evaluate_energy_span_model(self, T, p, etype="free", verbose=False,
                                   opath=None):
        """Upstream-compatible evaluation: returns (tof, Espan, TDTS, TDI,
        num_i, num_j, lTi, lIj). The model runs on the owning System's
        device."""
        vals = self._landscape_vector(T, p, etype, verbose)
        is_ts = self.is_ts
        dev = self._system.device
        res = energy_span_model(torch.as_tensor(vals, device=dev),
                                torch.as_tensor(is_ts, device=dev),
                                float(T))
        ts_rows = np.flatnonzero(is_ts > 0)
        int_cols = [i for i in range(1, len(vals) - 1) if is_ts[i] == 0]
        num_i = [float(res.x_ts[i]) for i in ts_rows]
        num_j = [float(res.x_int[j]) for j in int_cols]
        tdts = self.labels[int(res.i_tdts)]
        tdi = self.labels[int(res.i_tdi)]
        l_ti = [self.labels[i] for i in ts_rows]
        l_ij = [self.labels[i] for i in range(len(vals))
                if is_ts[i] == 0][1:-1]
        if verbose:
            print(f"Energy span ({T:.0f} K): TOF={float(res.tof):.3g} 1/s, "
                  f"Espan={float(res.espan):.3g} eV, TDTS={tdts}, TDI={tdi}")
        if opath is not None:
            with open(opath, "w") as fh:
                fh.write(str(float(res.tof)) + "\n")
                fh.write(", ".join([str(v) for v in num_i] + ["\n"]))
                fh.write(", ".join([str(v) for v in num_j] + ["\n"]))
        return (float(res.tof), float(res.espan), tdts, tdi,
                num_i, num_j, l_ti, l_ij)
