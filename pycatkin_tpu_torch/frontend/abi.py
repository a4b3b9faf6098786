"""Mechanism ABI: a mechanism zero-padded into a static shape bucket
(PyTorch port of the lowering in ``pycatkin_tpu/frontend/abi.py``).

A mechanism's species, reactions and dynamic slots are padded to the
bucket sizes below, so every mechanism of a bucket runs at the same
shapes. The padded dynamic dimension ``D`` is a power of two, which
puts the direction solves of most mechanisms on the batched-LU kernels'
bucket sizes (16, 32, 128, 512), and the Lyapunov certificate's basis
is padded to :data:`LYAP_PAD` columns, so its Kronecker system is
always 16 x 16.

Padding is an exact no-op on the real block: pad reactions are ghosts
(``kf = kr = 0``); pad species have zero stoichiometry rows and zero
thermo masks; the activity sentinel ``n_s`` of the index tables becomes
``S``; pad dynamic slots point at the reserved last species slot and
carry the residual ``F = -x`` (``dyn_mask``), so the padded Jacobian is
``blkdiag(J_real, -I)``.

Several mechanisms of one bucket pack into a :class:`PackedLowered`
(:func:`pack_lowered`), the unit of the packed multi-tenant sweep
(``parallel.batch.packed_sweep_steady_state``).

Each bucket has the JAX package's fingerprint string
(:func:`abi_fingerprint_of`, ``AbiLowered.abi_fingerprint``; a pack's
adds its tenant-count tag ``:tK``). The port compiles nothing per shape,
so no cache is keyed on it; the request coalescer
(``parallel.dispatch.SweepCoalescer``) groups requests by it, so only
mechanisms of one bucket are packed together. The program-spec
interning that keys the JAX package's compile caches is not ported.
"""

from __future__ import annotations

from dataclasses import fields as _dc_fields
from typing import NamedTuple

import numpy as np

from .spec import Conditions, ModelSpec

ABI_VERSION = 1

# Primary buckets: padded species dim S (>= n_s + 1: the last slot is
# reserved so pad dynamic/scaling indices never alias a real species)
# and padded reaction dim R (>= n_r).
SPECIES_BUCKETS = (16, 32, 128, 512)
REACTION_BUCKETS = (16, 64, 256, 1024)

# Secondary dims, fixed across all buckets.
FREQ_PAD = 32        # vibrational modes per species
ARITY_PAD = 6        # reac_idx / prod_idx width
GROUPS_PAD = 8       # site-conservation groups
SCALING_PAD = 8      # linear-scaling states
LYAP_PAD = 4         # deflated dim of the Lyapunov certificate basis
_BOUNDARY_MARGIN = 0.05   # validate.py warns within 5% of a bucket edge


class AbiStatic(NamedTuple):
    """The bucket: padded species, reaction and dynamic dims plus the
    two shape-deciding scalars. ``precision`` is always ``"f64"``: the
    port's precision tier is a keyword of the sweep it runs
    (``sweep_steady_state(..., tier=...)``), not a property of the
    lowering, so one lowering serves both tiers."""
    abi_version: int
    n_species: int       # S (padded, includes the reserved pad slot)
    n_reactions: int     # R (padded)
    n_dynamic: int       # D (padded dynamic dim)
    reactor_type: int
    desorption_model: str
    precision: str = "f64"


def tier_tag(precision: str) -> str:
    """Fingerprint suffix of a precision tier: empty for ``"f64"`` (the
    JAX package's ``precision.tier_tag``)."""
    return "" if precision == "f64" else ":p32"


def tenant_tag(k: int) -> str:
    """Fingerprint suffix of a pack's power-of-two tenant bucket
    (``:tK``); empty for ``k <= 1`` (the JAX package's
    ``compile_pool.tenant_tag``)."""
    k = int(k)
    if k <= 1:
        return ""
    if k & (k - 1):
        raise ValueError(f"tenant sub-buckets are powers of two, got {k} "
                         f"(pad the tenant axis with _pow2_at_least)")
    return f":t{k}"


def abi_fingerprint_of(static: AbiStatic) -> str:
    """The bucket's fingerprint, the JAX package's string:
    ``abi-v{ver}:s{S}:r{R}:d{D}:rt{rt}:{desorption}{tier_tag}``."""
    return ("abi-v{0}:s{1}:r{2}:d{3}:rt{4}:{5}{6}".format(
        static.abi_version, static.n_species, static.n_reactions,
        static.n_dynamic, static.reactor_type, static.desorption_model,
        tier_tag(static.precision)))


class AbiBucketError(ValueError):
    """A mechanism does not fit any ABI bucket; ``issues`` lists each
    offending dimension as ``(location, message)``."""

    def __init__(self, issues):
        self.issues = list(issues)
        lines = ["mechanism does not fit the ABI buckets:"]
        lines += [f"  {loc}: {msg}" for loc, msg in self.issues]
        super().__init__("\n".join(lines))


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < max(int(n), 1):
        p *= 2
    return p


def _bucket_for(n: int, buckets) -> int | None:
    for b in buckets:
        if n <= b:
            return int(b)
    return None


def _deflated_dim(spec: ModelSpec) -> int:
    from ..solvers.newton import deflation_basis_for_spec
    return int(deflation_basis_for_spec(spec).shape[1])


def select_static(spec: ModelSpec) -> AbiStatic:
    """Pick the bucket for ``spec``, raising :class:`AbiBucketError`
    with a per-dimension diagnostic when the mechanism cannot fit."""
    n_s, n_r = spec.n_species, spec.n_reactions
    issues = []

    S = _bucket_for(n_s + 1, SPECIES_BUCKETS)
    if S is None:
        issues.append((
            "/abi/species",
            f"{n_s} species (+1 reserved pad slot) exceed "
            f"bucket {max(SPECIES_BUCKETS)}"))
    R = _bucket_for(n_r, REACTION_BUCKETS)
    if R is None:
        issues.append((
            "/abi/reactions",
            f"{n_r} reactions exceed bucket {max(REACTION_BUCKETS)}"))
    if spec.freq.shape[1] > FREQ_PAD:
        issues.append(("/abi/freq",
                       f"{spec.freq.shape[1]} vibrational modes exceed "
                       f"the fixed pad {FREQ_PAD}"))
    if spec.reac_idx.shape[1] > ARITY_PAD:
        issues.append(("/abi/arity",
                       f"reaction arity {spec.reac_idx.shape[1]} exceeds "
                       f"the fixed pad {ARITY_PAD}"))
    if spec.groups.shape[0] > GROUPS_PAD:
        issues.append(("/abi/groups",
                       f"{spec.groups.shape[0]} conservation groups exceed "
                       f"the fixed pad {GROUPS_PAD}"))
    if spec.scl_idx.size > SCALING_PAD:
        issues.append(("/abi/scaling",
                       f"{spec.scl_idx.size} scaling states exceed "
                       f"the fixed pad {SCALING_PAD}"))
    if issues:
        raise AbiBucketError(issues)

    n_dyn = int(np.asarray(spec.dynamic_indices).size)
    D = _pow2_at_least(n_dyn)
    m = _deflated_dim(spec)
    if 0 < m <= LYAP_PAD:
        # The Lyapunov basis needs LYAP_PAD - m distinct pad dynamic
        # slots for its unit pad columns (QtJQ = blkdiag(B, -I)).
        while D - n_dyn < LYAP_PAD - m:
            D *= 2
    return AbiStatic(abi_version=ABI_VERSION, n_species=S, n_reactions=R,
                     n_dynamic=D, reactor_type=int(spec.reactor_type),
                     desorption_model=str(spec.desorption_model))


def _pad_to(a, shape, fill=0.0):
    """Extend ``a`` with trailing pads of value ``fill`` to ``shape``."""
    a = np.asarray(a)
    widths = [(0, t - s) for s, t in zip(a.shape, shape)]
    return np.pad(a, widths, constant_values=np.asarray(fill, a.dtype))


def _padded_spec(spec: ModelSpec, st: AbiStatic) -> ModelSpec:
    """The zero-padded host-side ModelSpec for a bucket. Pad rules:

    - pad reactions are ghosts (kf=kr=0) with neutral physical fields
      (area/masses 1.0 so no log/0-division paths are fed zeros);
    - pad species have zero thermo masks, zero stoichiometry rows and
      unit mass/sigma/inertia;
    - index tables remap the activity sentinel n_s -> S and send pad
      entries to S (reac/prod) or S-1 (scaling/dynamic scatter
      targets, which land in the reserved pad species slot).
    """
    S, R = st.n_species, st.n_reactions
    n_s, n_r = spec.n_species, spec.n_reactions
    F, A = FREQ_PAD, ARITY_PAD

    reac_idx = np.asarray(spec.reac_idx).copy()
    prod_idx = np.asarray(spec.prod_idx).copy()
    reac_idx[reac_idx == n_s] = S
    prod_idx[prod_idx == n_s] = S

    dyn = _pad_to(spec.dynamic_indices, (st.n_dynamic,), S - 1)
    pad_sp = [f"__abi_pad_s{i}" for i in range(S - n_s)]
    pad_rx = [f"__abi_pad_r{i}" for i in range(R - n_r)]

    kw = dict(
        snames=tuple(spec.snames) + tuple(pad_sp),
        state_types=tuple(spec.state_types) + ("abi_pad",) * (S - n_s),
        freq=_pad_to(spec.freq, (S, F)),
        fmask=_pad_to(spec.fmask, (S, F)),
        mass=_pad_to(spec.mass, (S,), 1.0),
        sigma=_pad_to(spec.sigma, (S,), 1.0),
        inertia=_pad_to(spec.inertia, (S, 3), 1.0),
        is_gas=_pad_to(spec.is_gas, (S,)),
        is_linear=_pad_to(spec.is_linear, (S,)),
        mix=_pad_to(spec.mix, (S, S)),
        gelec0=_pad_to(spec.gelec0, (S,)),
        add0=_pad_to(spec.add0, (S,)),
        gvibr0=_pad_to(spec.gvibr0, (S,)),
        gvibr_mask=_pad_to(spec.gvibr_mask, (S,)),
        gtran0=_pad_to(spec.gtran0, (S,)),
        gtran_mask=_pad_to(spec.gtran_mask, (S,)),
        grota0=_pad_to(spec.grota0, (S,)),
        grota_mask=_pad_to(spec.grota_mask, (S,)),
        gfree0=_pad_to(spec.gfree0, (S,)),
        gfree_mask=_pad_to(spec.gfree_mask, (S,)),
        scl_idx=_pad_to(spec.scl_idx, (SCALING_PAD,), S - 1),
        scl_b=_pad_to(spec.scl_b, (SCALING_PAD,)),
        scl_We=_pad_to(spec.scl_We, (SCALING_PAD, S)),
        scl_Ws=_pad_to(spec.scl_Ws, (SCALING_PAD, SCALING_PAD)),
        scl_WuE=_pad_to(spec.scl_WuE, (SCALING_PAD, R)),
        udar_mask=_pad_to(spec.udar_mask, (S,)),
        udar_Ce=_pad_to(spec.udar_Ce, (S, S)),
        udar_Cg=_pad_to(spec.udar_Cg, (S, S)),
        udar_CuE=_pad_to(spec.udar_CuE, (S, R)),
        udar_CuG=_pad_to(spec.udar_CuG, (S, R)),
        rnames=tuple(spec.rnames) + tuple(pad_rx),
        reac_types=tuple(spec.reac_types) + ("abi_pad",) * (R - n_r),
        SR=_pad_to(spec.SR, (R, S)),
        SP=_pad_to(spec.SP, (R, S)),
        ST=_pad_to(spec.ST, (R, S)),
        has_TS=_pad_to(spec.has_TS, (R,)),
        reversible=_pad_to(spec.reversible, (R,)),
        base_reversible=_pad_to(spec.base_reversible, (R,)),
        is_arr_type=_pad_to(spec.is_arr_type, (R,)),
        is_ads=_pad_to(spec.is_ads, (R,)),
        is_des=_pad_to(spec.is_des, (R,)),
        is_ghost=_pad_to(spec.is_ghost, (R,), 1.0),
        is_user=_pad_to(spec.is_user, (R,)),
        area=_pad_to(spec.area, (R,), 1.0),
        rscaling=_pad_to(spec.rscaling, (R,), 1.0),
        site_density=_pad_to(spec.site_density, (R,)),
        gas_mass=_pad_to(spec.gas_mass, (R,), 1.0),
        gas_sigma=_pad_to(spec.gas_sigma, (R,), 1.0),
        gas_inertia=_pad_to(spec.gas_inertia, (R, 3), 1.0),
        gas_polyatomic=_pad_to(spec.gas_polyatomic, (R,)),
        reac_idx=_pad_to(reac_idx, (R, A), S),
        prod_idx=_pad_to(prod_idx, (R, A), S),
        stoich=_pad_to(spec.stoich, (S, R)),
        reactor_type=spec.reactor_type,
        volume=spec.volume,
        catalyst_area=spec.catalyst_area,
        residence_time=spec.residence_time,
        is_adsorbate=_pad_to(spec.is_adsorbate, (S,)),
        is_gas_dyn=_pad_to(spec.is_gas_dyn, (S,)),
        dynamic_indices=dyn,
        adsorbate_indices=np.asarray(spec.adsorbate_indices).copy(),
        gas_indices=np.asarray(spec.gas_indices).copy(),
        groups=_pad_to(spec.groups, (GROUPS_PAD, S)),
        desorption_model=spec.desorption_model,
    )
    missing = {f.name for f in _dc_fields(ModelSpec)} - set(kw)
    if missing:   # a new ModelSpec field must pick a pad rule explicitly
        raise AbiBucketError([("/abi/fields",
                               f"no ABI pad rule for spec fields "
                               f"{sorted(missing)} (bump ABI_VERSION)")])
    return ModelSpec(**kw)


def _lyapunov_operands(spec: ModelSpec, st: AbiStatic):
    """Padded deflation basis Q [D, LYAP_PAD] and its validity flag.

    The real basis (from the original spec) is extended with unit
    columns on distinct pad dynamic slots, making QtJQ =
    blkdiag(B_real, -I): the certificate's verdict on the padded system
    equals its verdict on the real one. When the real deflated dim
    exceeds LYAP_PAD (or is 0), lyap_ok = 0 and the certificate
    abstains for every lane."""
    from ..solvers.newton import deflation_basis_for_spec
    n_dyn = int(np.asarray(spec.dynamic_indices).size)
    Q_real = np.asarray(deflation_basis_for_spec(spec), dtype=np.float64)
    m = Q_real.shape[1]
    Q = np.zeros((st.n_dynamic, LYAP_PAD), dtype=np.float64)
    ok = 0 < m <= LYAP_PAD and (st.n_dynamic - n_dyn) >= (LYAP_PAD - m)
    if ok:
        Q[:n_dyn, :m] = Q_real
        for j in range(LYAP_PAD - m):
            Q[n_dyn + j, m + j] = 1.0
    return Q, np.float64(1.0 if ok else 0.0)


class AbiLowered:
    """One mechanism lowered into a bucket: the padded host-side spec
    (``spec_padded``), the lowering's own device operands as numpy
    arrays (``dyn_mask`` ``[D]``: 1 on real dynamic slots, 0 on pad
    slots; ``lyap_q`` ``[D, LYAP_PAD]``: the padded deflation basis;
    ``lyap_ok``: 1.0 when the Lyapunov certificate can decide, else
    0.0) and the pad/unpad helpers for host arrays."""

    def __init__(self, base: ModelSpec, static: AbiStatic):
        self.static = static
        self.spec_padded = _padded_spec(base, static)
        self.n_s_real = base.n_species
        self.n_r_real = base.n_reactions
        self.n_dyn_real = int(np.asarray(base.dynamic_indices).size)
        self.dyn_mask = np.zeros((static.n_dynamic,), dtype=np.float64)
        self.dyn_mask[:self.n_dyn_real] = 1.0
        self.lyap_q, lyap_ok = _lyapunov_operands(base, static)
        self.lyap_ok = float(lyap_ok)

    @property
    def abi_fingerprint(self) -> str:
        """The bucket's fingerprint (:func:`abi_fingerprint_of`)."""
        return abi_fingerprint_of(self.static)

    # -- boundary padding -------------------------------------------------
    def pad_conditions(self, conds: Conditions) -> Conditions:
        S, R = self.static.n_species, self.static.n_reactions
        sp = lambda a, fill=0.0: _pad_last(a, S - self.n_s_real, fill)
        rx = lambda a, fill=0.0: _pad_last(a, R - self.n_r_real, fill)
        return conds._replace(
            gelec=sp(conds.gelec), eps=sp(conds.eps), y0=sp(conds.y0),
            inflow=sp(conds.inflow),
            uE_rxn=rx(conds.uE_rxn), uG_rxn=rx(conds.uG_rxn),
            uEa=rx(conds.uEa), uGa=rx(conds.uGa),
            u_rxn_mask=rx(conds.u_rxn_mask), u_bar_mask=rx(conds.u_bar_mask),
            is_activated=rx(conds.is_activated),
            kscale=rx(conds.kscale, 1.0))

    def pad_x0(self, x0):
        if x0 is None:
            return None
        return _pad_last(x0, self.static.n_dynamic - self.n_dyn_real, 0.0)

    def pad_tof_mask(self, mask):
        if mask is None:
            return None
        return _pad_last(mask, self.static.n_reactions - self.n_r_real, 0.0)

    def unpad_y(self, y):
        """Strip pad species from a [..., S] composition axis."""
        return y[..., :self.n_s_real]


def _pad_last(a, pad: int, fill):
    a = np.asarray(a)
    if pad == 0:
        return a
    widths = [(0, 0)] * (a.ndim - 1) + [(0, pad)]
    return np.pad(a, widths, constant_values=np.asarray(fill, a.dtype))


# ----------------------------------------------------------------------
# multi-tenant packing

# The padded-spec arrays that differ between the mechanisms of a bucket
# (the JAX package's traced operands); host-only build-time fields and the
# unpadded adsorbate / gas index lists are left out.
OPERAND_FIELDS = (
    "freq", "fmask", "mass", "sigma", "inertia", "is_gas", "is_linear",
    "mix", "add0", "gvibr0", "gvibr_mask", "gtran0", "gtran_mask",
    "grota0", "grota_mask", "gfree0", "gfree_mask",
    "scl_idx", "scl_b", "scl_We", "scl_Ws", "scl_WuE",
    "udar_mask", "udar_Ce", "udar_Cg", "udar_CuE", "udar_CuG",
    "SR", "SP", "ST", "has_TS", "reversible", "is_ads", "is_des",
    "is_ghost", "is_user", "area", "gas_mass", "gas_sigma",
    "gas_inertia", "gas_polyatomic", "reac_idx", "prod_idx", "stoich",
    "is_adsorbate", "dynamic_indices", "groups",
)


def _stack(leaves):
    return np.stack([np.asarray(v) for v in leaves])


class PackedLowered:
    """K :class:`AbiLowered` mechanisms of one bucket on a leading
    *tenant* axis: the unit the packed sweep runs as one lane batch.

    ``k`` is the tenant count, ``k_bucket`` the next power of two and
    ``occupancy = k / k_bucket``, as in the JAX package, whose ghost
    tenants (replicas of tenant 0 up to ``k_bucket``) keep its compiled
    shapes a small family. The port compiles nothing per shape, so it
    computes no ghost tenant: everything stacked here has ``k`` entries,
    and ``k_bucket`` and ``occupancy`` are kept for parity only.
    :meth:`operands` stacks the tenants' padded spec arrays and lowering
    operands; :meth:`stack_tenants` and the pad helpers stack per-tenant
    inputs (numpy) the same way."""

    def __init__(self, lows):
        lows = tuple(lows)
        if not lows:
            raise AbiBucketError([("pack", "cannot pack zero tenants")])
        issues = []
        for i, low in enumerate(lows):
            if not isinstance(low, AbiLowered):
                issues.append((f"tenant {i}",
                               f"not an AbiLowered (got "
                               f"{type(low).__name__}); lower each "
                               f"mechanism with lower_spec/maybe_lower "
                               f"first"))
            elif low.static != lows[0].static:
                issues.append((f"tenant {i}",
                               f"bucket {tuple(low.static)} != tenant 0's "
                               f"{tuple(lows[0].static)}; only same-bucket "
                               f"mechanisms can be packed"))
        if issues:
            raise AbiBucketError(issues)
        self.tenants = lows
        self.k = len(lows)
        self.k_bucket = _pow2_at_least(self.k)
        self.static = lows[0].static

    @property
    def occupancy(self) -> float:
        """Tenants over the power-of-two tenant bucket."""
        return self.k / self.k_bucket

    @property
    def abi_fingerprint(self) -> str:
        """The bucket's fingerprint plus the tenant-count tag
        (:func:`tenant_tag` of ``k_bucket``), as in the JAX package."""
        return abi_fingerprint_of(self.static) + tenant_tag(self.k_bucket)

    def operands(self) -> dict:
        """The padded specs' :data:`OPERAND_FIELDS`, and ``dyn_mask``,
        ``lyap_q`` and ``lyap_ok``, stacked on a leading ``[k]`` tenant
        axis (numpy)."""
        out = {name: _stack(getattr(low.spec_padded, name)
                            for low in self.tenants)
               for name in OPERAND_FIELDS}
        for name in ("dyn_mask", "lyap_q", "lyap_ok"):
            out[name] = _stack(getattr(low, name) for low in self.tenants)
        return out

    def stack_tenants(self, per_tenant):
        """Stack ``k`` per-tenant values (arrays, or :class:`Conditions`
        field by field, already padded to the bucket) on a leading tenant
        axis; all None gives None."""
        per_tenant = list(per_tenant)
        if len(per_tenant) != self.k:
            raise ValueError(f"expected {self.k} per-tenant values, got "
                             f"{len(per_tenant)}")
        if all(v is None for v in per_tenant):
            return None
        if any(v is None for v in per_tenant):
            raise ValueError("per-tenant inputs must be all present or all "
                             "None across the pack")
        if isinstance(per_tenant[0], Conditions):
            return Conditions(*(_stack(f) for f in zip(*per_tenant)))
        return _stack(per_tenant)

    def pad_conditions(self, conds_list) -> Conditions:
        """Each tenant's conditions padded to the bucket, then stacked:
        ``[k, lanes, bucket dims]`` fields."""
        return self.stack_tenants(
            [low.pad_conditions(c) for low, c in zip(self.tenants,
                                                     conds_list)])

    def pad_tof_mask(self, masks):
        if masks is None or all(m is None for m in masks):
            return None
        return self.stack_tenants(
            [low.pad_tof_mask(m) for low, m in zip(self.tenants, masks)])

    def pad_x0(self, x0s):
        if x0s is None or all(x is None for x in x0s):
            return None
        return self.stack_tenants(
            [low.pad_x0(x) for low, x in zip(self.tenants, x0s)])

    def unpad_y(self, y, tenant: int):
        """Strip pad species from tenant ``tenant``'s composition axis."""
        return self.tenants[tenant].unpad_y(y)


def pack_lowered(lows) -> PackedLowered:
    """Pack K lowered mechanisms of one ABI bucket; raises
    :class:`AbiBucketError` when they span buckets."""
    return PackedLowered(lows)


def lower_spec(spec: ModelSpec) -> AbiLowered:
    """Lower ``spec`` into its ABI bucket."""
    return AbiLowered(spec, select_static(spec))


def maybe_lower(spec: ModelSpec):
    """:func:`lower_spec`, or None with a warning when ``spec`` fits no
    bucket (the caller then runs the unpadded mechanism, as the JAX
    package's ``maybe_lower`` gate does)."""
    try:
        return lower_spec(spec)
    except AbiBucketError as e:
        import warnings
        warnings.warn(
            f"abi=True but the mechanism does not fit any ABI bucket; "
            f"running it unpadded. {e}", stacklevel=3)
        return None
