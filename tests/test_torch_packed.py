"""The packed multi-tenant sweep of the port: K mechanisms of one ABI
bucket run their fast pass as one lane batch, and each tenant's result
is its solo ``sweep_steady_state(..., abi=True)`` (``torch.equal`` on
every key) under both precision tiers, on clean and rescue corpora; the
clean path pulls one bundle, not K. Against the JAX package's
``packed_sweep_steady_state`` (``PYCATKIN_ABI=1``, its Pallas kernels in
interpret mode): verdicts bitwise, states within the envelope (rtol 1e-5
/ atol 1e-12; the f32-polish tier's rtol 5e-2 / atol 1e-12)."""

import dataclasses

import numpy as np
import pytest
import torch

from pycatkin_tpu import precision as jprecision
from pycatkin_tpu.frontend import abi as jabi
from pycatkin_tpu.models.synthetic import synthetic_system
from pycatkin_tpu.parallel import batch as jbatch
from pycatkin_tpu_torch.frontend import abi
from pycatkin_tpu_torch.frontend.spec import (conditions_from_arrays,
                                              spec_from_arrays)
from pycatkin_tpu_torch.parallel import batch
from pycatkin_tpu_torch.solvers import newton
from pycatkin_tpu_torch.solvers.newton import SolverOptions

N_LANES = 12
SEEDS = (0, 1, 2, 3)
MASKS = ("success", "quarantined", "stable", "rate_ok", "pos_ok", "sums_ok")
ENVELOPE = {"f64": dict(rtol=1e-5, atol=1e-12),
            "f32-polish": dict(rtol=5e-2, atol=1e-12)}


def _jax_tenant(seed, n=N_LANES, shape=(12, 14), T=(430.0, 720.0)):
    """The JAX packed tests' tenant: synthetic (12, 14) of ``seed``, T
    430-720 K, the TOF of the last reaction."""
    sim = synthetic_system(*shape, seed=seed)
    sj = sim.spec
    cj = jbatch.broadcast_conditions(sim.conditions(), n)._replace(
        T=np.linspace(*T, n))
    mask = np.zeros(sj.n_reactions)
    mask[-1] = 1.0
    return sj, cj, mask


def _port(t):
    sj, cj, mask = t
    spec = spec_from_arrays(
        {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)})
    conds = conditions_from_arrays(
        {f: np.asarray(getattr(cj, f)) for f in cj._fields})
    return spec, conds, mask


@pytest.fixture(scope="module")
def tenants():
    jt = [_jax_tenant(s) for s in SEEDS]
    return jt, [_port(t) for t in jt]


def _solo(ts, **kw):
    return [batch.sweep_steady_state(s, c, m, abi=True, device="cpu", **kw)
            for s, c, m in ts]


def _packed(ts, **kw):
    return batch.packed_sweep_steady_state(
        [t[0] for t in ts], [t[1] for t in ts], [t[2] for t in ts],
        device="cpu", **kw)


def _bits(t):
    """``t`` as integers of its width: equal bits, NaN included."""
    if not t.is_floating_point():
        return t
    return t.contiguous().view({8: torch.int64, 4: torch.int32}[
        t.element_size()])


def _assert_tenant_equal(solo, packed, context):
    """Every key ``torch.equal``, a float key compared by its bits (a
    NaN lane's NaN is equal to itself there)."""
    assert sorted(solo) == sorted(packed), context
    for key in solo:
        assert solo[key].dtype == packed[key].dtype, (context, key)
        assert torch.equal(_bits(solo[key]), _bits(packed[key])), (context,
                                                                   key)


def test_pack_fingerprint_and_occupancy(tenants):
    """K = 3 packs into a tenant bucket of 4 (occupancy 0.75, no ghost
    tenant computed); the operands and the padded inputs stack on a
    leading tenant axis of 3, each slice its tenant's."""
    _, pt = tenants
    lows = [abi.lower_spec(t[0]) for t in pt[:3]]
    pack = abi.pack_lowered(lows)
    assert pack.k == 3 and pack.k_bucket == 4
    assert pack.occupancy == pytest.approx(0.75)
    assert pack.static == lows[0].static
    ops = pack.operands()
    for key, arr in ops.items():
        assert arr.shape[0] == 3, key
    for i, low in enumerate(lows):
        np.testing.assert_array_equal(ops["stoich"][i],
                                      low.spec_padded.stoich)
        np.testing.assert_array_equal(ops["lyap_q"][i], low.lyap_q)
        assert ops["lyap_ok"][i] == low.lyap_ok
    conds = pack.pad_conditions([t[1] for t in pt[:3]])
    S = pack.static.n_species
    assert conds.y0.shape == (3, N_LANES, S)
    np.testing.assert_array_equal(conds.y0[1],
                                  lows[1].pad_conditions(pt[1][1]).y0)
    masks = pack.pad_tof_mask([t[2] for t in pt[:3]])
    assert masks.shape == (3, pack.static.n_reactions)
    assert pack.pad_x0(None) is None
    assert pack.pad_tof_mask([None] * 3) is None
    with pytest.raises(ValueError, match="all present or all None"):
        pack.stack_tenants([masks[0], None, masks[2]])
    y = np.zeros((N_LANES, S))
    assert pack.unpad_y(y, 2).shape == (N_LANES, lows[2].n_s_real)


def test_pack_rejects_mixed_buckets(tenants):
    _, pt = tenants
    small = abi.lower_spec(pt[0][0])
    big = abi.lower_spec(_port(_jax_tenant(5, shape=(40, 80)))[0])
    assert small.static != big.static
    with pytest.raises(abi.AbiBucketError, match="same-bucket"):
        abi.pack_lowered([small, big])
    with pytest.raises(abi.AbiBucketError, match="not an AbiLowered"):
        abi.pack_lowered([small, pt[1][0]])
    with pytest.raises(abi.AbiBucketError):
        batch.packed_sweep_steady_state(
            [pt[0][0], big.spec_padded], pt[0][1], device="cpu")


def test_single_tenant_delegates_to_solo_path(tenants):
    _, pt = tenants
    s, c, m = pt[0]
    out = batch.packed_sweep_steady_state([s], [c], [m], device="cpu")
    assert len(out) == 1
    _assert_tenant_equal(_solo(pt[:1])[0], out[0], "K=1")
    assert batch.packed_sweep_steady_state([], [], device="cpu") == []


def test_packed_inputs_are_checked(tenants):
    _, pt = tenants
    specs = [t[0] for t in pt[:2]]
    short = type(pt[1][1])(*(np.asarray(f)[:5] for f in pt[1][1]))
    with pytest.raises(ValueError, match="share a lane count"):
        batch.packed_sweep_steady_state(specs, [pt[0][1], short],
                                        device="cpu")
    with pytest.raises(ValueError, match="every tenant or none"):
        batch.packed_sweep_steady_state(specs, [pt[0][1], pt[1][1]],
                                        [pt[0][2], None], device="cpu")
    with pytest.raises(ValueError, match="3 entries for 2 tenants"):
        batch.packed_sweep_steady_state(specs, [pt[0][1]] * 3,
                                        device="cpu")


def test_mechanism_without_a_bucket_runs_solo_sweeps(tenants):
    """A tenant that fits no bucket (reaction arity 7) sends every tenant
    to its solo sweep: the lowered one through its bucket, the other
    unpadded."""
    _, pt = tenants
    s, c, m = pt[1]
    wide = lambda a: np.pad(np.asarray(a), ((0, 0), (0, 7 - a.shape[1])),
                            constant_values=s.n_species)
    s_wide = dataclasses.replace(s, reac_idx=wide(s.reac_idx),
                                 prod_idx=wide(s.prod_idx))
    with pytest.warns(UserWarning, match="does not fit any ABI bucket"):
        out = batch.packed_sweep_steady_state(
            [pt[0][0], s_wide], [pt[0][1], c], [pt[0][2], m], device="cpu")
    _assert_tenant_equal(_solo(pt[:1])[0], out[0], "lowered tenant")
    ref = batch.sweep_steady_state(s_wide, c, m, device="cpu")
    _assert_tenant_equal(ref, out[1], "unpadded tenant")


@pytest.mark.parametrize("tier", ["f64", "f32-polish"])
def test_clean_corpus_bit_identical(tenants, tier):
    """Four tenants, every lane converged: each equal to its solo sweep,
    key by key, with one bundle pulled for the pack and the PTC march's
    syncs those of its slowest tenant's solo sweep, not their sum."""
    _, pt = tenants
    syncs = []
    solo = []
    for t in pt:
        newton.reset_syncs()
        solo += _solo([t], check_stability=True, tier=tier)
        syncs.append(dict(newton.SYNCS))
    newton.reset_syncs()
    packed = _packed(pt, check_stability=True, tier=tier)
    assert newton.SYNCS["sweep_bundle"] == 1
    assert newton.SYNCS["ptc_active"] == max(s["ptc_active"] for s in syncs)
    for k, (so, pa) in enumerate(zip(solo, packed)):
        assert bool(so["success"].all())
        _assert_tenant_equal(so, pa, f"clean/{tier}/tenant{k}")
    if tier == "f32-polish":
        assert all(bool((pa["lane_telemetry"][:, 4] == 1).all())
                   for pa in packed)


@pytest.mark.parametrize("tier", ["f64", "f32-polish"])
def test_rescue_tenant_leaves_co_tenants_unchanged(tenants, tier):
    """Tenant 1 has a NaN temperature on lane 3, and crippled pacing fails
    lanes of every tenant into the rescue ladder (under f64): each tenant
    walks its own solo tail, and every tenant of the pack equals its solo
    sweep."""
    _, pt = tenants
    bad = np.asarray(pt[1][1].T).copy()
    bad[3] = np.nan
    ts = list(pt)
    ts[1] = (pt[1][0], pt[1][1]._replace(T=bad), pt[1][2])
    opts = SolverOptions(max_steps=4, max_attempts=2)
    solo = _solo(ts, opts=opts, check_stability=True, tier=tier)
    assert not bool(solo[1]["success"].all())
    if tier == "f64":
        # (The float32 bulk's floored tolerances converge these lanes in
        # four steps: under f32-polish only tenant 1 escalates.)
        assert any(bool((s["lane_telemetry"][:, 3] >= 1).any())
                   for s in solo)
    packed = _packed(ts, opts=opts, check_stability=True, tier=tier)
    for k, (so, pa) in enumerate(zip(solo, packed)):
        _assert_tenant_equal(so, pa, f"rescue/{tier}/tenant{k}")


@pytest.mark.parametrize("tier", ["f64", "f32-polish"])
def test_packed_matches_jax_packed(tenants, tier, monkeypatch):
    """Against the JAX package's packed sweep of the same four tenants:
    verdict masks and the telemetry's strategy and tier columns bitwise,
    states within the tier's envelope."""
    jt, pt = tenants
    monkeypatch.setenv(jprecision.TIER_ENV, tier)
    monkeypatch.setenv(jprecision.KERNEL_ENV, "pallas")
    monkeypatch.setenv(jabi.ABI_ENV, "1")
    monkeypatch.setenv("PYCATKIN_AOT_CACHE", "off")
    jbatch.clear_program_caches()
    try:
        pj = jbatch.packed_sweep_steady_state(
            [t[0] for t in jt], [t[1] for t in jt], tof_mask=[t[2] for t in jt],
            check_stability=True)
        pj = [{k: np.asarray(v) for k, v in o.items()} for o in pj]
    finally:
        jbatch.clear_program_caches()
    packed = _packed(pt, check_stability=True, tier=tier)
    for k, (pa, oj) in enumerate(zip(packed, pj)):
        assert sorted(pa) == sorted(oj), k
        for key in MASKS:
            assert np.array_equal(pa[key].numpy(), oj[key]), (k, key)
        assert np.array_equal(pa["lane_telemetry"][:, 3:].numpy(),
                              oj["lane_telemetry"][:, 3:]), k
        np.testing.assert_allclose(pa["y"].numpy(), oj["y"],
                                   err_msg=f"tenant {k}", **ENVELOPE[tier])
