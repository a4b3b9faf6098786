"""Batched thermochemistry (PyTorch port of ``pycatkin_tpu/ops/thermo.py``).

Free-energy contributions for all species at once as functions of (T, p)
and static padded spec tensors. ``T`` and ``p`` carry the lane shape
``[...]`` (a 0-d tensor for one condition); per-species results come out
``[..., n_s]``. Units: eV; T in K; p in Pa; frequencies in Hz; masses in
amu; moments of inertia in amu*A^2. The expressions keep the JAX
package's operation order term for term.
"""

from __future__ import annotations

import math

import torch

from ..constants import JtoeV, LOG_ROT_CONST, LOG_TRANS_CONST, h, kB


def _lane(x, extra: int):
    """Append ``extra`` singleton axes to a lane-shaped tensor."""
    return x.reshape(x.shape + (1,) * extra)


def zero_point_energy(freq, fmask):
    """ZPE[eV] = 0.5*h*sum(f) per species over the modes in ``fmask``."""
    return 0.5 * h * torch.sum(freq * fmask, dim=-1) * JtoeV


def vibrational_energy(T, freq, fmask):
    """Harmonic vibrational free energy incl. ZPE per species:
    Gvibr = ZPE + kB*T*sum(ln(1 - exp(-h*f/kB*T))) [eV]."""
    zpe = zero_point_energy(freq, fmask)
    x = freq * h / (kB * _lane(T, 2))
    on = fmask > 0
    log_term = torch.where(
        on, torch.log1p(-torch.exp(-torch.where(on, x, torch.ones_like(x)))),
        torch.zeros_like(x))
    return zpe + kB * _lane(T, 1) * torch.sum(log_term, dim=-1) * JtoeV


def translational_energy(T, p, mass, is_gas):
    """Ideal-gas translational free energy per species; 0 for non-gas:
    Gtran = -kB*T*ln[(kB*T/p) * (2*pi*m*kB*T/h^2)^1.5] [eV], assembled in
    log space from LOG_TRANS_CONST."""
    T1, p1 = _lane(T, 1), _lane(p, 1)
    m_amu = torch.where(is_gas > 0, mass, torch.ones_like(mass))
    log_q = torch.log(kB * T1 / p1) + 1.5 * (LOG_TRANS_CONST
                                             + torch.log(m_amu * T1))
    return torch.where(is_gas > 0, -kB * T1 * log_q * JtoeV,
                       torch.zeros_like(log_q))


def _prod_last(x):
    """Product over the last axis as a left-to-right chain of multiplies
    (a fixed order, the same for every lane)."""
    out = x[..., 0]
    for i in range(1, x.shape[-1]):
        out = out * x[..., i]
    return out


def rotational_energy(T, inertia, sigma, is_gas, is_linear):
    """Rigid-rotor rotational free energy per species. Linear molecules:
    -kB*T*ln(8*pi^2*kB*T*I/(sigma*h^2)) with I the geometric mean of the
    nonzero pair; non-linear:
    -kB*T*ln(sqrt(pi)/sigma * (8*pi^2*kB*T/h^2)^1.5 * sqrt(prod I))."""
    T1 = _lane(T, 1)
    prod_amu = _prod_last(torch.where(inertia > 0, inertia,
                                      torch.ones_like(inertia)))
    log_q_lin = LOG_ROT_CONST + torch.log(T1 * torch.sqrt(prod_amu) / sigma)
    log_q_nonlin = (0.5 * math.log(math.pi) - torch.log(sigma)
                    + 1.5 * (LOG_ROT_CONST + torch.log(T1))
                    + 0.5 * torch.log(prod_amu))
    g = -kB * T1 * torch.where(is_linear > 0, log_q_lin,
                               log_q_nonlin) * JtoeV
    has_inertia = torch.sum(inertia, dim=-1) > 0
    return torch.where((is_gas > 0) & has_inertia, g, torch.zeros_like(g))


def thermal_contributions(T, p, *, freq, fmask, mass, sigma, inertia,
                          is_gas, is_linear, mix,
                          gvibr0, gvibr_mask, gtran0, gtran_mask,
                          grota0, grota_mask):
    """(Gvibr, Gtran, Grota) [eV], each ``[..., n_s]``, with input-file
    overrides and gas-mixture (``mix`` [n_s, n_s]) corrections applied."""
    gv = vibrational_energy(T, freq, fmask)
    gt = translational_energy(T, p, mass, is_gas)
    gr = rotational_energy(T, inertia, sigma, is_gas, is_linear)
    gv = torch.where(gvibr_mask > 0, gvibr0, gv)
    gt = torch.where(gtran_mask > 0, gtran0, gt)
    gr = torch.where(grota_mask > 0, grota0, gr)
    gt = gt + gt @ mix.T
    gr = gr + gr @ mix.T
    return gv, gt, gr
