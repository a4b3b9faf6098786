"""Input-validation gate: reject broken mechanisms before they compile.

A copy of ``pycatkin_tpu/frontend/validate.py`` (the same checks, the
same report and the same ``PYCATKIN_VALIDATE`` gate modes).

Malformed specs -- non-finite energies, stoichiometrically unbalanced
reactions, orphan species, missing frequencies -- otherwise sail
straight into the solvers and come back out as per-lane NaNs
with no attribution (the quarantine layer in ``parallel/batch.py``
then catches them, but a fault that is knowable at LOAD time should
never reach a device). This module runs host-side checks over a
:class:`~pycatkin_tpu_torch.api.system.System`'s in-memory states, reactions
and parameters and collects every finding into a structured
:class:`ValidationReport` whose issues carry JSON-pointer-style
locations (``/reactions/CO_ox/reactants``) that map 1:1 onto the
input-file schema.

Severity model: an **error** is a spec the solvers cannot give a
meaningful answer for (non-finite energy, unbalanced stoichiometry,
non-physical T/p, negative inflow); a **warning** is a spec that will
run but probably not the one the user meant (orphan species, missing
adsorbate/TS frequencies, absurd-magnitude energies).

Gate modes (the ``PYCATKIN_VALIDATE`` environment variable, or
``System.build(strict=...)``):

- ``strict``: errors raise :class:`ValidationError`; warnings warn.
- ``warn`` (default): every issue becomes a ``UserWarning``.
- ``off``: the gate is skipped entirely.

The checks never trigger DFT-artifact loading (``State.load``): only
values already in memory are judged, so validating a path-based input
stays I/O-free and cannot itself raise a parser error.
"""

from __future__ import annotations

import math
import os
import warnings
from dataclasses import dataclass, field

from .reactions import GHOST
from .states import ADSORBATE, GAS, SURFACE, TS

# |Gelec| beyond this (eV) is almost certainly a unit mistake
# (Hartree/kJ/mol pasted into an eV field); finite, so it only warns.
ABSURD_ENERGY_EV = 1.0e4
# T above this (K) warns; <= 0 or non-finite errors.
ABSURD_T_K = 1.0e4
# p above this (Pa) warns (1e10 Pa = 100 GPa).
ABSURD_P_PA = 1.0e10
# Relative mass-imbalance tolerance per reaction.
MASS_BALANCE_RTOL = 1.0e-6

VALIDATE_ENV = "PYCATKIN_VALIDATE"
_MODES = ("strict", "warn", "off")


@dataclass(frozen=True)
class ValidationIssue:
    """One finding: severity ('error'|'warning'), JSON-pointer-style
    location into the input schema, and a human-readable message."""
    severity: str
    location: str
    message: str

    def __str__(self):
        return f"[{self.severity}] {self.location}: {self.message}"


@dataclass
class ValidationReport:
    """Structured result of the validation gate.

    ``source`` names the input file (or None for in-memory systems);
    ``issues`` accumulate in check order. ``ok`` is True when no
    issue is an error (warnings never fail a build)."""
    source: str | None = None
    issues: list = field(default_factory=list)

    def error(self, location: str, message: str):
        self.issues.append(ValidationIssue("error", location, message))

    def warn(self, location: str, message: str):
        self.issues.append(ValidationIssue("warning", location, message))

    @property
    def errors(self) -> list:
        return [i for i in self.issues if i.severity == "error"]

    @property
    def warnings(self) -> list:
        return [i for i in self.issues if i.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def __str__(self):
        src = f" for {self.source}" if self.source else ""
        if not self.issues:
            return f"validation report{src}: clean"
        lines = [f"validation report{src}: {len(self.errors)} error(s), "
                 f"{len(self.warnings)} warning(s)"]
        lines += [f"  {i}" for i in self.issues]
        return "\n".join(lines)

    def raise_for_errors(self):
        if self.errors:
            raise ValidationError(self)
        return self

    def emit(self, mode: str):
        """Apply gate semantics: 'strict' raises on errors (and warns
        the warnings), 'warn' warns everything, 'off' does nothing.
        Returns the report for chaining."""
        if mode not in _MODES:
            raise ValueError(
                f"validation mode must be one of {_MODES}, got {mode!r}")
        if mode == "off":
            return self
        if mode == "strict":
            self.raise_for_errors()
        for issue in self.issues:
            warnings.warn(f"{self.source or 'mechanism'}: {issue}",
                          UserWarning, stacklevel=3)
        return self


class ValidationError(RuntimeError):
    """Strict-mode gate failure; carries the full report as
    ``.report``."""

    def __init__(self, report: ValidationReport):
        super().__init__(str(report))
        self.report = report


def validation_mode(default: str = "warn") -> str:
    """Resolve the gate mode from :data:`VALIDATE_ENV` (default
    'warn'). An unrecognized value raises rather than silently
    disabling the gate."""
    mode = os.environ.get(VALIDATE_ENV, "").strip().lower() or default
    if mode not in _MODES:
        raise ValueError(
            f"{VALIDATE_ENV} must be one of {_MODES}, got {mode!r}")
    return mode


def _finite(value) -> bool:
    try:
        return math.isfinite(float(value))
    except (TypeError, ValueError):
        return False


def _check_energy(report, location: str, value):
    """Non-finite scalar energies error; absurd magnitudes warn.
    Per-temperature dict values are checked entry-wise."""
    if value is None:
        return
    if isinstance(value, dict):
        for k, v in value.items():
            _check_energy(report, f"{location}/{k}", v)
        return
    if not _finite(value):
        report.error(location, f"non-finite energy {value!r}")
    elif abs(float(value)) > ABSURD_ENERGY_EV:
        report.warn(location,
                    f"energy {float(value):g} eV is absurdly large -- "
                    f"wrong units?")


def _surface_sites(states) -> int:
    """Number of surface sites a reaction side occupies: each bare
    surface or adsorbate state holds one site; gas and TS hold none."""
    return sum(1 for s in states
               if s.state_type in (SURFACE, ADSORBATE))


def _reaction_mass(states):
    """Total mass of a reaction side, or None when any participant's
    mass is unknown in memory (path-based states resolve lazily; the
    gate never triggers loading)."""
    total = 0.0
    for s in states:
        if s.mass is None or not _finite(s.mass):
            return None
        total += float(s.mass)
    return total


def validate_system(system, source: str | None = None) -> ValidationReport:
    """Run every check over a :class:`System`'s host-side objects.

    Pure inspection: no spec build, no DFT-artifact loading, no device
    work. Returns the :class:`ValidationReport`; callers apply gate
    semantics via :meth:`ValidationReport.emit` or
    :meth:`ValidationReport.raise_for_errors`.
    """
    report = ValidationReport(source=source)
    states = dict(getattr(system, "states", {}) or {})
    reactions = dict(getattr(system, "reactions", {}) or {})
    params = dict(getattr(system, "params", {}) or {})

    # -- states: energies, frequencies ---------------------------------
    for name, st in states.items():
        _check_energy(report, f"/states/{name}/Gelec", st.Gelec)
        for attr in ("Gzpe", "Gvibr", "Gtran", "Grota", "Gfree",
                     "add_to_energy"):
            _check_energy(report, f"/states/{name}/{attr}",
                          getattr(st, attr, None))
        # Adsorbates/TS with neither in-memory frequencies nor any
        # lazy source (path / vibs_path / fixed Gvibr or Gfree) have
        # no vibrational entropy at all -- legal, rarely intended.
        if (st.state_type in (ADSORBATE, TS)
                and not getattr(st, "is_scaling", False)
                and st.freq is None and st.path is None
                and st.vibs_path is None and st.Gvibr is None
                and st.Gfree is None):
            report.warn(f"/states/{name}/freq",
                        f"{st.state_type} state has no vibrational "
                        f"frequencies and no source to load them from")

    # -- reactions: balance, dangling references, user energies --------
    referenced: set = set()
    for rname, rx in reactions.items():
        reac = list(getattr(rx, "reactants", []) or [])
        prod = list(getattr(rx, "products", []) or [])
        ts = list(getattr(rx, "TS", None) or [])
        for s in reac + prod + ts:
            referenced.add(s.name)
        for attr in ("dErxn_user", "dGrxn_user", "dEa_fwd_user",
                     "dGa_fwd_user", "dEa_rev_user", "dGa_rev_user"):
            _check_energy(report, f"/reactions/{rname}/{attr}",
                          getattr(rx, attr, None))
        if rx.reac_type == GHOST:
            # Ghost steps are bookkeeping devices, exempt from
            # stoichiometric balance by construction.
            continue
        if not reac or not prod:
            report.error(f"/reactions/{rname}",
                         "reaction must have at least one reactant and "
                         "one product")
            continue
        # Site balance: mean-field kinetics conserve surface sites in
        # every elementary step; an imbalance means a missing/extra
        # surface species in the input.
        ns_r, ns_p = _surface_sites(reac), _surface_sites(prod)
        if ns_r != ns_p:
            report.error(
                f"/reactions/{rname}",
                f"surface-site imbalance: reactants occupy {ns_r} "
                f"site(s) ({[s.name for s in reac]}), products occupy "
                f"{ns_p} ({[s.name for s in prod]})")
        # Mass balance, where every participant's mass is known
        # in memory (adsorbate masses usually resolve lazily -> skip).
        m_r, m_p = _reaction_mass(reac), _reaction_mass(prod)
        if m_r is not None and m_p is not None:
            tol = MASS_BALANCE_RTOL * max(m_r, m_p, 1.0)
            if abs(m_r - m_p) > tol:
                report.error(
                    f"/reactions/{rname}",
                    f"mass imbalance: reactants {m_r:g} amu vs "
                    f"products {m_p:g} amu")

    # -- orphan species ------------------------------------------------
    if reactions:
        for name, st in states.items():
            if st.state_type in (SURFACE, TS):
                continue          # sites/TS legitimately appear nowhere
            if getattr(st, "is_scaling", False):
                continue          # descriptors live in scaling relations
            if name not in referenced:
                report.warn(f"/states/{name}",
                            "species appears in no reaction (orphan)")

    # -- conditions: T, p ----------------------------------------------
    T = params.get("temperature")
    if T is not None:
        if not _finite(T) or float(T) <= 0.0:
            report.error("/system/T",
                         f"temperature must be finite and positive, "
                         f"got {T!r}")
        elif float(T) > ABSURD_T_K:
            report.warn("/system/T",
                        f"temperature {float(T):g} K is absurdly high")
    p = params.get("pressure")
    if p is not None:
        if not _finite(p) or float(p) <= 0.0:
            report.error("/system/p",
                         f"pressure must be finite and positive, "
                         f"got {p!r}")
        elif float(p) > ABSURD_P_PA:
            report.warn("/system/p",
                        f"pressure {float(p):g} Pa is absurdly high")

    # -- start/inflow compositions -------------------------------------
    for key in ("start_state", "inflow_state"):
        comp = params.get(key) or {}
        for name, frac in comp.items():
            loc = f"/system/{key}/{name}"
            if name not in states:
                report.error(loc, "references an unknown state")
                continue
            if not _finite(frac) or float(frac) < 0.0:
                report.error(loc,
                             f"fraction must be finite and >= 0, "
                             f"got {frac!r}")
            if key == "inflow_state" and \
                    states[name].state_type != GAS:
                report.error(loc,
                             "only gas states can comprise the inflow")
    return report


def check_abi_headroom(spec, report: ValidationReport | None = None
                       ) -> ValidationReport:
    """Warn when a BUILT mechanism lands within the boundary margin
    (frontend/abi.py ``_BOUNDARY_MARGIN``, 5%) of its ABI shape
    bucket's edge. A mechanism hugging the boundary is one species or
    a few reactions away from spilling into the next bucket -- which
    under ``PYCATKIN_ABI=1`` means new program identities and the full
    compile/prewarm wall again, exactly the cost the ABI exists to
    amortize. Runs on a :class:`~pycatkin_tpu_torch.frontend.spec.ModelSpec`
    (the counts the bucket selector sees), unlike the host-object
    checks above; :func:`pycatkin_tpu_torch.frontend.abi.lower_spec` emits
    these warnings once per mechanism."""
    from .abi import (_BOUNDARY_MARGIN, REACTION_BUCKETS, SPECIES_BUCKETS,
                      _bucket_for)
    if report is None:
        report = ValidationReport()
    pct = int(round(_BOUNDARY_MARGIN * 100))
    for loc, n, buckets, what in (
            ("/abi/species", spec.n_species + 1, SPECIES_BUCKETS,
             "species (incl. the reserved pad slot)"),
            ("/abi/reactions", spec.n_reactions, REACTION_BUCKETS,
             "reactions")):
        b = _bucket_for(n, buckets)
        if b is None:
            continue            # unfittable: lowering raises, not warns
        if n > b * (1.0 - _BOUNDARY_MARGIN):
            report.warn(
                loc,
                f"{n} {what} is within {pct}% of the ABI bucket "
                f"boundary {b}; slight mechanism growth spills into "
                f"the next bucket (padded shape {loc.rsplit('/', 1)[-1]}"
                f"={b} -> {_next_bucket(b, buckets)}) and repays the "
                f"full compile/prewarm wall")
    return report


def _next_bucket(b: int, buckets) -> object:
    larger = [x for x in buckets if x > b]
    return min(larger) if larger else "unfittable"
