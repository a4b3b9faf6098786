"""Precision tiers (PyTorch port of ``pycatkin_tpu/precision.py``).

Under ``tier="f32-polish"`` the fast pass runs its PTC march in float32,
then a short float64 Newton polish, and takes the verdict in float64 at
the caller's tolerances (:func:`..solvers.newton.solve_steady`); a lane
the polish cannot carry fails like a float64 failure and goes through
the float64 rescue ladder. ``"f64"`` runs every iteration in float64.

The tier is a keyword of the entry points (``sweep_steady_state(...,
tier="f32-polish")``), not an environment variable, and an eager port
has no compiled programs to key on it: the JAX package's ``tier_tag`` /
``kernel_tag`` / ``kernel_keyed`` have no counterpart here.
"""

from __future__ import annotations

import torch

#: Recognised tiers: ``"f64"`` every iteration in float64,
#: ``"f32-polish"`` the bulk march in float32, then a float64 polish and
#: the float64 verdict.
TIERS = ("f64", "f32-polish")

#: The lane telemetry's tier column: which tier produced the accepted
#: iterate (0 also for every rescue-ladder product, which is float64).
TIER_CODES = {"f64": 0, "f32-polish": 1}
TIER_NAMES = tuple(sorted(TIER_CODES, key=TIER_CODES.get))


def check_tier(tier: str) -> str:
    """``tier`` if it is one of :data:`TIERS`; raises on anything else
    (a typo must not run float64 silently)."""
    if tier not in TIERS:
        raise ValueError(f"tier={tier!r}: unknown precision tier (expected "
                         f"one of {', '.join(TIERS)})")
    return tier


def bulk_dtype(tier: str) -> torch.dtype:
    """The dtype of the bulk march under ``tier``."""
    return torch.float32 if check_tier(tier) == "f32-polish" \
        else torch.float64


def verify_dtype() -> torch.dtype:
    """The dtype of every verdict and certificate, whatever the tier."""
    return torch.float64


def cast_bulk(x, tier: str):
    """``x`` as a tensor of the bulk dtype of ``tier`` (no copy under
    ``"f64"`` for a float64 tensor)."""
    return torch.as_tensor(x).to(bulk_dtype(tier))


def cast_verify(x):
    """``x`` back in the verification dtype (float64)."""
    return torch.as_tensor(x).to(verify_dtype())
