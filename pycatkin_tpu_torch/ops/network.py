"""Reaction-network RHS, gross-flux scale and closed-form Jacobian
(PyTorch port of ``pycatkin_tpu/ops/network.py``).

With padded reactant/product index tensors the rate of reaction j is
``k_j * prod_a y_ext[idx[j, a]]`` and the species balance is one product
with the weighted stoichiometric matrix. Every function works on a
trailing species axis with any leading lane shape ``[...]``, so it serves
both the batched sweep and the per-lane functions that
``torch.func.vmap`` / ``jacfwd`` trace.

Conventions: gas entries of y are in bar and enter rates as Pa
(y * 1e5); surface/adsorbate entries are coverages; ``stoich`` folds the
reaction ``scaling`` and the per-gas-row ``site_density`` factors in.
"""

from __future__ import annotations

import torch

from ..constants import bartoPa
from ..frontend.spec import REACTOR_ID


def _y_ext(y, is_gas):
    """Effective activities with the padding slot (index n_s) = 1."""
    y_eff = torch.where(is_gas > 0, y * bartoPa, y)
    return torch.cat([y_eff, torch.ones_like(y_eff[..., :1])], dim=-1)


def _slot_product(vals):
    """Product over the last (arity) axis as a left-to-right chain."""
    out = vals[..., 0]
    for a in range(1, vals.shape[-1]):
        out = out * vals[..., a]
    return out


def net_rates(y, kf, kr, *, reac_idx, prod_idx, is_gas):
    """Forward, reverse and net rates of every reaction, ``[..., n_r]``
    each. ``reac_idx``/``prod_idx``: [n_r, A] species indices padded with
    n_s (a virtual species of constant activity 1).

    The net rate ``kf * prod - rev`` is rounded once (``addcmul``): XLA's
    CPU backend fuses the JAX package's ``fwd - rev`` into one
    multiply-add, and ``addcmul`` rounds once on the CPU too, so the net
    rates there are bit for bit the reference's. A last-bit difference
    in them grows along the steady solver's march to ~1e-5 in its final
    residual."""
    y_ext = _y_ext(y, is_gas)
    pf = _slot_product(y_ext[..., reac_idx])
    rev = kr * _slot_product(y_ext[..., prod_idx])
    return kf * pf, rev, torch.addcmul(-rev, kf, pf)


def reactor_rhs(y, kf, kr, **reactor):
    """dy/dt alone: :func:`reactor_rhs_and_scale` without the gross
    flux (the same arithmetic for the rate of change)."""
    return _reactor(y, kf, kr, False, **reactor)[0]


def reactor_rhs_and_scale(y, kf, kr, **reactor):
    """``(dy/dt, gross)``: the reactor ODE right-hand side and the
    per-species GROSS flux ``|S| @ (|fwd| + |rev|)`` (plus |flow| terms)
    under the same reactor row transforms -- the steadiness yardstick of
    the steady solver.

    - InfiniteDilution: gas rows are clamped (multiplied by 0).
    - CSTR: gas rows are scaled by sigma/bartoPa (``sigma_over_bar``,
      lane-shaped) and gain the flow term (inflow - y)/tau.

    Keywords: ``reac_idx``, ``prod_idx``, ``is_gas``, ``stoich``,
    ``is_adsorbate``, ``reactor_type``, ``sigma_over_bar``, ``inv_tau``,
    ``inflow``."""
    return _reactor(y, kf, kr, True, **reactor)


def _reactor(y, kf, kr, with_gross, *, reac_idx, prod_idx, is_gas,
             stoich, is_adsorbate, reactor_type, sigma_over_bar, inv_tau,
             inflow):
    fwd, rev, net = net_rates(y, kf, kr, reac_idx=reac_idx,
                              prod_idx=prod_idx, is_gas=is_gas)
    chem = net @ stoich.T
    gross = (torch.abs(fwd) + torch.abs(rev)) @ torch.abs(stoich).T \
        if with_gross else None
    if reactor_type == REACTOR_ID:
        return chem * is_adsorbate, \
            None if gross is None else gross * is_adsorbate
    sob = sigma_over_bar.reshape(sigma_over_bar.shape + (1,))
    row_scale = torch.where(is_adsorbate > 0, torch.ones_like(chem), sob)
    zero = torch.zeros_like(chem)
    flow = torch.where(is_gas > 0, (inflow - y) * inv_tau, zero)
    if gross is None:
        return chem * row_scale + flow, None
    gflow = torch.where(is_gas > 0, (inflow + torch.abs(y)) * inv_tau, zero)
    return chem * row_scale + flow, gross * row_scale + gflow


def _excl_products(P):
    """[..., n_r, A] -> products over all OTHER slots (left/right
    cumulative products -- no division, so zero factors stay exact)."""
    ones = torch.ones_like(P[..., :1])
    left = torch.cat([ones, torch.cumprod(P[..., :-1], dim=-1)], dim=-1)
    right = torch.cat(
        [torch.flip(torch.cumprod(torch.flip(P[..., 1:], [-1]), dim=-1),
                    [-1]), ones], dim=-1)
    return left * right


def chem_jacobian(y, kf, kr, *, reac_idx, prod_idx, is_gas, stoich):
    """Closed-form d(chemistry rhs)/dy, ``[..., n_s, n_s]`` -- the
    independent implementation that the tests hold the ``jacfwd``
    Jacobian against."""
    n_s = y.shape[-1]
    y_ext = _y_ext(y, is_gas)
    unit = torch.where(is_gas > 0, torch.full_like(is_gas, bartoPa),
                       torch.ones_like(is_gas))
    species = torch.arange(n_s, device=y.device)
    oh_r = (reac_idx[:, :, None] == species).to(y.dtype)
    oh_p = (prod_idx[:, :, None] == species).to(y.dtype)
    cf = kf[..., None] * _excl_products(y_ext[..., reac_idx])
    cr = kr[..., None] * _excl_products(y_ext[..., prod_idx])
    Jf = torch.einsum("...ra,ran->...rn", cf, oh_r)
    Jr = torch.einsum("...ra,ran->...rn", cr, oh_p)
    return (stoich @ (Jf - Jr)) * unit


def reactor_jacobian(y, kf, kr, *, reac_idx, prod_idx, is_gas, stoich,
                     is_adsorbate, reactor_type, sigma_over_bar, inv_tau,
                     inflow):
    """Closed-form d(reactor rhs)/dy under the same row transforms as
    :func:`reactor_rhs_and_scale`."""
    J = chem_jacobian(y, kf, kr, reac_idx=reac_idx, prod_idx=prod_idx,
                      is_gas=is_gas, stoich=stoich)
    if reactor_type == REACTOR_ID:
        return J * is_adsorbate[:, None]
    sob = sigma_over_bar.reshape(sigma_over_bar.shape + (1, 1))
    row_scale = torch.where(is_adsorbate[:, None] > 0,
                            torch.ones_like(J), sob)
    J = J * row_scale
    return J - torch.diag(torch.where(is_gas > 0, inv_tau * torch.ones_like(
        is_gas), torch.zeros_like(is_gas)))
