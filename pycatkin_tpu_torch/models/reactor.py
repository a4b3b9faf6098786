"""Reactor models: boundary conditions wrapped around the chemistry RHS.

Host-side configuration objects (port of ``pycatkin_tpu/models/reactor.py``);
the transform itself is applied in
:func:`pycatkin_tpu_torch.ops.network.reactor_rhs_and_scale`.

- :class:`InfiniteDilutionReactor`: gas composition is a fixed boundary
  condition; only surface species evolve.
- :class:`CSTReactor`: continuously stirred tank; gas balances carry the
  site-rate -> pressure-rate scaling sigma = kB*T*A_cat/V and the flow
  term (p_in - p)/tau, with tau = V/Q if not given.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..frontend.spec import REACTOR_CSTR, REACTOR_ID


@dataclass
class Reactor:
    name: str = "reactor"
    volume: Optional[float] = None
    catalyst_area: Optional[float] = None
    residence_time: Optional[float] = None
    flow_rate: Optional[float] = None

    reactor_type = REACTOR_ID

    def params(self) -> dict:
        return {"volume": self.volume, "catalyst_area": self.catalyst_area,
                "residence_time": self.residence_time,
                "flow_rate": self.flow_rate}


@dataclass
class InfiniteDilutionReactor(Reactor):
    reactor_type = REACTOR_ID


@dataclass
class CSTReactor(Reactor):
    reactor_type = REACTOR_CSTR

    def __post_init__(self):
        if self.residence_time is None:
            assert self.flow_rate is not None and self.volume is not None, (
                "CSTReactor needs residence_time or (volume, flow_rate)")
            self.residence_time = self.volume / self.flow_rate
