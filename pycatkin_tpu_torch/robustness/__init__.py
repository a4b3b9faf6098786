"""Failure subsystem (port of the parts of ``pycatkin_tpu/robustness``
the serving path calls): :mod:`.faults`, deterministic fault injection
at named sites. The degradation ladder, the sweep journal, the chunked
runner, the elastic scheduler and the forensics are not ported yet
(ROADMAP.md Queue A)."""

from .faults import (FaultPlan, FaultSpec, InjectedDeviceLossError,
                     InjectedTransientError, fault_scope)

__all__ = ["FaultPlan", "FaultSpec", "InjectedDeviceLossError",
           "InjectedTransientError", "fault_scope"]
