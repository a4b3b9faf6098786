"""Host-side elementary-step description (numpy only).

Pure data holders; rate-constant math lives in
:mod:`pycatkin_tpu_torch.ops.rates`. Port of
``pycatkin_tpu/frontend/reactions.py``: reaction types arrhenius /
adsorption / desorption / ghost, reversibility, site area and rate
scaling, user-supplied energies (scalar or per-temperature dict) and
energy borrowing from a base reaction.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Optional

from .states import GAS, State

ARRHENIUS = "arrhenius"
ADSORPTION = "adsorption"
DESORPTION = "desorption"
GHOST = "ghost"

REAC_TYPES = (ARRHENIUS, ADSORPTION, DESORPTION, GHOST)


@dataclass
class Reaction:
    name: str = "reaction"
    reac_type: str = None
    reversible: bool = True
    reactants: list = field(default_factory=list)
    products: list = field(default_factory=list)
    TS: Optional[list] = None
    area: float = 1.0e-19
    scaling: float = 1.0

    def __post_init__(self):
        rt = str(self.reac_type).lower()
        if rt in ("scaling", "base"):
            # Upstream schema aliases: both dispatch as activated steps.
            rt = ARRHENIUS
        if rt not in REAC_TYPES:
            raise ValueError(
                f"reaction {self.name}: reac_type must be one of "
                f"{REAC_TYPES}, got {self.reac_type!r}")
        self.reac_type = rt

    @property
    def energy_states(self) -> "Reaction":
        """The reaction whose states define this reaction's energetics
        (:class:`ReactionDerivedReaction` overrides it)."""
        return self

    def gas_species(self) -> Optional[State]:
        """The single gas species that adsorbs/desorbs, if applicable."""
        if self.reac_type == ADSORPTION:
            pool = self.reactants
        elif self.reac_type == DESORPTION:
            pool = self.products
        else:
            return None
        gas = [s for s in pool if s.state_type == GAS]
        assert len(gas) == 1, (
            f"reaction {self.name}: must have exactly one gas-phase species "
            "adsorbing or desorbing per elementary step")
        return gas[0]

    @property
    def is_user_defined(self) -> bool:
        return False

    @property
    def site_density(self) -> float:
        return 1.0 / self.area if self.area else 0.0


def _resolve_user_value(value, T: float):
    """User energies may be scalars or dicts keyed by temperature;
    intermediate temperatures interpolate linearly, temperatures outside
    the table raise."""
    if value is None:
        return None
    if isinstance(value, dict):
        T = float(T)
        table = {float(k): float(v) for k, v in value.items()}
        if T in table:
            return table[T]
        keys = sorted(table)
        if T < keys[0] or T > keys[-1]:
            raise ValueError(
                f"user energy tabulated for T in [{keys[0]}, {keys[-1]}] K "
                f"only; cannot extrapolate to T={T} K")
        hi = bisect.bisect_left(keys, T)
        lo, hi = keys[hi - 1], keys[hi]
        w = (T - lo) / (hi - lo)
        return (1.0 - w) * table[lo] + w * table[hi]
    return float(value)


@dataclass
class UserDefinedReaction(Reaction):
    """Reaction with user-supplied energies in eV."""

    dErxn_user: Optional[object] = None
    dEa_fwd_user: Optional[object] = None
    dEa_rev_user: Optional[object] = None
    dGrxn_user: Optional[object] = None
    dGa_fwd_user: Optional[object] = None
    dGa_rev_user: Optional[object] = None

    @property
    def is_user_defined(self) -> bool:
        return True

    def resolved_user_energies(self, T: float) -> dict:
        """User energies at T: dErxn<->dGrxn and the barrier pair fall back
        to each other; a reaction with neither barrier gets 0.0."""
        dErxn = _resolve_user_value(self.dErxn_user, T)
        dGrxn = _resolve_user_value(self.dGrxn_user, T)
        if dErxn is None and dGrxn is not None:
            dErxn = dGrxn
        if dGrxn is None and dErxn is not None:
            dGrxn = dErxn
        dEa = _resolve_user_value(self.dEa_fwd_user, T)
        dGa = _resolve_user_value(self.dGa_fwd_user, T)
        if dEa is None and dGa is not None:
            dEa = dGa
        if dGa is None and dEa is not None:
            dGa = dEa
        return {
            "dErxn": dErxn,
            "dGrxn": dGrxn,
            "dEa_fwd": dEa if dEa is not None else 0.0,
            "dGa_fwd": dGa if dGa is not None else 0.0,
            "has_rxn_energy": dErxn is not None,
            "has_barrier": dEa is not None,
        }


@dataclass
class ReactionDerivedReaction(Reaction):
    """Reaction that borrows its energetics from another reaction with
    different stoichiometry."""

    base_reaction: Optional[Reaction] = None

    def __post_init__(self):
        super().__post_init__()
        assert self.base_reaction is not None, (
            f"reaction {self.name}: base_reaction is required")

    @property
    def energy_states(self) -> Reaction:
        return self.base_reaction
