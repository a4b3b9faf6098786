"""Batched rate constants (PyTorch port of ``pycatkin_tpu/ops/rates.py``).

TST / collision-theory rate constants for the whole network at once.
Reaction-type dispatch is resolved at spec-build time into static masks;
here everything is branch-free ``where`` algebra. ``T`` carries the lane
shape ``[...]``; per-reaction inputs and outputs are ``[..., n_r]``.

Units: T [K], barriers/reaction energies [J/mol], masses [amu], areas
[m^2], moments of inertia [amu*A^2]. Arrhenius/desorption constants in
[1/s]; adsorption in [1/(s*Pa)].
"""

from __future__ import annotations

import torch

from ..constants import (LOG_DES_LIN, LOG_DES_POLY, R, ROT_THETA_AMU,
                         SQRT_2PI_AMU_KB, h, kB)


def _lane(x):
    return x.reshape(x.shape + (1,))


def prefactor(T):
    """TST prefactor kB*T/h [1/s]."""
    return kB * T / h


def k_arrhenius(T, prefac, barrier):
    """A*exp(-Ea/RT)."""
    return prefac * torch.exp(-barrier / (R * T))


def k_adsorption(T, mass, area):
    """Collision-theory sticking rate area/sqrt(2*pi*m*kB*T) [1/(s*Pa)]."""
    return area / (SQRT_2PI_AMU_KB * torch.sqrt(mass * T))


def k_desorption(T, mass, area, sigma, inertia, is_polyatomic, des_en):
    """Desorption from detailed balance with the gas rotational partition
    function, assembled in log space (``des_en`` in J/mol; ``T`` already
    broadcast against the reaction axis)."""
    theta = ROT_THETA_AMU / torch.where(inertia > 0, inertia,
                                        torch.ones_like(inertia))
    log_theta_prod = torch.sum(
        torch.where(inertia > 0, torch.log(theta),
                    torch.zeros_like(theta)), dim=-1)
    log_poly = (LOG_DES_POLY + 3.5 * torch.log(T)
                + torch.log(area * mass / sigma) - log_theta_prod)
    I_max = torch.max(inertia, dim=-1).values
    theta_lin = ROT_THETA_AMU / torch.where(I_max > 0, I_max,
                                            torch.ones_like(I_max))
    log_lin = (LOG_DES_LIN + 3.0 * torch.log(T)
               + torch.log(area * mass / sigma) - torch.log(theta_lin))
    log_coeff = torch.where(is_polyatomic > 0, log_poly, log_lin)
    return torch.exp(log_coeff - des_en / (R * T))


def keq_thermo(T, rxn_en):
    """exp(-dG/RT)."""
    return torch.exp(-rxn_en / (R * T))


def rate_constants(T, *, dGrxn, dErxn, dGa_fwd,
                   is_arr, is_ads, is_des, is_ghost, reversible,
                   area, gas_mass, gas_sigma, gas_inertia, gas_polyatomic,
                   kscale, collision_des: bool = False):
    """Forward/reverse rate constants for every reaction, ``(kf, kr, Keq)``.

    - ``is_arr``: activated step: kf = (kBT/h)exp(-max(dGa_fwd,0)/RT),
      kr = kf/Keq.
    - ``is_ads``: non-activated adsorption: kf = kads, kr by the
      desorption model.
    - ``is_des``: non-activated desorption: mirror of adsorption.
    - ``is_ghost``: kf = kr = 0.
    ``reversible`` zeroes kr when 0; ``kscale`` multiplies kf and kr.
    ``collision_des`` selects the collision desorption model (rotational
    partition function with the electronic desorption energy) over the
    default detailed-balance one."""
    T = _lane(T)
    pre = prefactor(T)
    barrier = torch.clamp(dGa_fwd, min=0.0)
    keq = keq_thermo(T, dGrxn)

    kf_arr = k_arrhenius(T, pre, barrier)
    kr_arr = kf_arr / keq

    kf_ads = k_adsorption(T, gas_mass, area)
    if collision_des:
        kr_ads = k_desorption(T, gas_mass, area, gas_sigma, gas_inertia,
                              gas_polyatomic, -dErxn)
        kf_des = k_desorption(T, gas_mass, area, gas_sigma, gas_inertia,
                              gas_polyatomic, dErxn)
    else:
        kr_ads = kf_ads / keq
        kf_des = k_adsorption(T, gas_mass, area) * keq
    kr_des = k_adsorption(T, gas_mass, area)

    zero = torch.zeros_like(kf_arr)
    kf = torch.where(is_arr > 0, kf_arr,
                     torch.where(is_ads > 0, kf_ads,
                                 torch.where(is_des > 0, kf_des, zero)))
    kr = torch.where(is_arr > 0, kr_arr,
                     torch.where(is_ads > 0, kr_ads,
                                 torch.where(is_des > 0, kr_des, zero)))
    kf = torch.where(is_ghost > 0, zero, kf)
    kr = torch.where(is_ghost > 0, zero, kr) * (reversible > 0)
    return kf * kscale, kr * kscale, keq
