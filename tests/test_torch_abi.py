"""The port's ABI route against the JAX package's on identical data.

- Lowering: ``frontend.abi.select_static`` / ``lower_spec`` give the
  same bucket and bitwise the same operands (each entry of the JAX
  package's ``AbiLowered._np_operands`` against the padded spec's field
  or the lowering's own ``dyn_mask``/``lyap_q``/``lyap_ok``), and the
  same per-dimension ``AbiBucketError``.
- The ABI fused sweep: the port's ``fused_sweep`` on an ``AbiLowered``
  against the JAX ABI program (``_fused_sweep_program(low.program_spec,
  ...)``) run under ``PYCATKIN_LINALG_KERNEL=pallas`` -- the TPU's
  routing, with the Pallas kernels in interpret mode on the CPU -- so
  both packages send the bucket-size direction solves (D = 32 on the
  flagship) and the 16 x 16 Kronecker solves to the batched LU.
- ``sweep_steady_state`` with ``abi`` True and False against the JAX
  one (``PYCATKIN_ABI`` set to match), including the tier-2 host
  eigensolve (the rescue ladder: ``tests/test_torch_rescue.py``).

Verdict masks and the diagnostics bundle must be bitwise equal; states,
TOF and activity within the repo's cross-kernel envelope, rtol 1e-5 /
atol 1e-12 (docs/perf_pallas_linalg.md)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycatkin_tpu import engine as jengine
from pycatkin_tpu import precision
from pycatkin_tpu.frontend import abi as jabi
from pycatkin_tpu.models.synthetic import synthetic_system
from pycatkin_tpu.parallel import batch as jbatch
from pycatkin_tpu.solvers import newton as jnewton
from pycatkin_tpu_torch import engine
from pycatkin_tpu_torch.frontend import abi
from pycatkin_tpu_torch.frontend.spec import (conditions_from_arrays,
                                              spec_from_arrays)
from pycatkin_tpu_torch.ops import cuda_linalg, linalg
from pycatkin_tpu_torch.parallel import batch

L = 8
NAMES = ("res", "quar", "cert", "amb", "tofs", "act", "neg", "telemetry",
         "bundle")
MASKS = ("success", "quarantined", "stable", "rate_ok", "pos_ok",
         "sums_ok")
INTS = ("iterations", "attempts", "chords", "lane_telemetry")
ENVELOPE = ("y", "tof", "activity", "dt_exit")


def _port_spec(sj):
    return spec_from_arrays(
        {f.name: getattr(sj, f.name) for f in dataclasses.fields(sj)})


def _port_conds(cj):
    return conditions_from_arrays(
        {f: np.asarray(getattr(cj, f)) for f in cj._fields})


def _case(ns, nr, T=(450.0, 650.0)):
    sysj = synthetic_system(ns, nr, seed=0)
    sj = sysj.spec
    cj = jbatch.broadcast_conditions(sysj.conditions(), L)._replace(
        T=jnp.linspace(*T, L))
    return sj, cj, jengine.tof_mask_for(sj, [sj.rnames[-1]])


def _envelope(a, b, name):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                               atol=1e-12, err_msg=name)


# ----------------------------------------------------------------------
# lowering
@pytest.mark.parametrize("shape", [(24, 32), (12, 14), (10, 5), (200, 200)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_lowering_matches_jax(shape):
    sj = synthetic_system(*shape, seed=0).spec
    jlow = jabi.lower_spec(sj)
    low = abi.lower_spec(_port_spec(sj))
    assert tuple(low.static) == tuple(jlow.static)
    own = ("dyn_mask", "lyap_q", "lyap_ok")
    assert set(own) <= set(jlow._np_operands)
    for k, want in jlow._np_operands.items():
        got = np.asarray(getattr(low, k) if k in own
                         else getattr(low.spec_padded, k))
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert np.array_equal(got, want), k
    assert low.n_dyn_real == jlow.n_dyn_real


def test_lowering_flags_the_certificate_buckets():
    """The slice's shapes: the flagship pads to D = 32 (a kernel bucket)
    with an abstaining certificate; (10, 5) to D = 8 with m = 4, so the
    padded 16 x 16 Kronecker system decides."""
    flag = abi.lower_spec(_port_spec(synthetic_system(24, 32).spec))
    assert flag.static[1:4] == (128, 64, 32) and flag.lyap_ok == 0.0
    small = abi.lower_spec(_port_spec(synthetic_system(10, 5).spec))
    assert small.static[1:4] == (16, 16, 8) and small.lyap_ok == 1.0
    assert small.lyap_q.shape == (8, abi.LYAP_PAD)
    ds = engine.bind(small, "cpu")
    assert torch.equal(ds.dyn_mask, torch.tensor(small.dyn_mask))
    assert torch.equal(ds.lyap_q, torch.tensor(small.lyap_q))
    assert float(ds.lyap_ok) == 1.0 and ds.n_species == 16


@pytest.mark.parametrize("shape,n_dyn", [((200, 200), 165),
                                         ((300, 200), 212)],
                         ids=["200x200", "300x200"])
def test_bucket_512_mechanisms_pad_to_d_256(shape, n_dyn):
    """The largest synthetic mechanisms that fit the 512-species bucket
    pad their dynamic block to D = 256: not a kernel bucket, so their
    solves take the LU route, which on a CUDA tensor runs the kernels'
    device-memory tier (the lane's 256 x 256 matrix exceeds shared
    memory)."""
    sj = synthetic_system(*shape, seed=0).spec
    low = abi.lower_spec(_port_spec(sj))
    assert jabi.select_static(sj) == low.static
    assert (low.static.n_species, low.n_dyn_real) == (512, n_dyn)
    assert low.static.n_dynamic == 256
    assert linalg.select_solver(256).path == "lu"


def _wide_arity(sp):
    """``sp`` with reaction arity 7 > ARITY_PAD: the extra slots hold
    the activity-1 sentinel."""
    wide = lambda a: np.pad(np.asarray(a), ((0, 0), (0, 7 - a.shape[1])),
                            constant_values=sp.n_species)
    return dataclasses.replace(sp, reac_idx=wide(sp.reac_idx),
                               prod_idx=wide(sp.prod_idx))


@pytest.mark.parametrize("case", ["too_big", "wide_arity"])
def test_bucket_errors_match_jax(case):
    if case == "too_big":
        sj = synthetic_system(300, 300, seed=0).spec
    else:
        sj = _wide_arity(synthetic_system(12, 14, seed=0).spec)
    with pytest.raises(jabi.AbiBucketError) as je:
        jabi.select_static(sj)
    with pytest.raises(abi.AbiBucketError) as pe:
        abi.select_static(_port_spec(sj))
    want = [(i.location, i.message) for i in je.value.report.issues]
    assert pe.value.issues == want and want
    assert str(pe.value) == str(je.value)
    assert isinstance(pe.value, ValueError)


def test_pad_round_trip_matches_jax():
    sj, cj, mask = _case(12, 14)
    jlow = jabi.lower_spec(sj)
    low = abi.lower_spec(_port_spec(sj))
    ct = _port_conds(cj)
    pc = low.pad_conditions(ct)
    for f, a, b in zip(ct._fields, pc, jlow.pad_conditions(cj)):
        assert np.array_equal(a, np.asarray(b)), f
    x0 = np.random.default_rng(0).random((L, low.n_dyn_real))
    assert np.array_equal(low.pad_x0(x0), jlow.pad_x0(x0))
    assert np.array_equal(low.pad_tof_mask(mask), jlow.pad_tof_mask(mask))
    y = np.asarray(pc.y0)
    assert y.shape == (L, 32)
    assert np.array_equal(low.unpad_y(y), np.asarray(ct.y0))
    assert low.pad_x0(None) is None and low.pad_tof_mask(None) is None


# ----------------------------------------------------------------------
# the ABI fused sweep
def _jax_abi_fused(sj, cj, mask):
    jlow = jabi.lower_spec(sj)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(precision.KERNEL_ENV, "pallas")
        jbatch.clear_program_caches()
        try:
            prog = jbatch._fused_sweep_program(
                jlow.program_spec, jbatch._fast_pass_opts(
                    jnewton.SolverOptions()), 1e-2, "cpu", True, True)
            keys = jax.random.split(jax.random.PRNGKey(0), L)
            out = prog(jlow.operands(), jlow.pad_conditions(cj), keys,
                       None, jnp.asarray(jlow.pad_tof_mask(mask)))
            return dict(zip(NAMES, jax.device_get(out)))
        finally:
            jbatch.clear_program_caches()


@pytest.mark.parametrize("shape", [(24, 32), (10, 5)],
                         ids=["flagship", "10x5"])
def test_abi_fused_sweep_matches_jax_pallas(shape):
    sj, cj, mask = _case(*shape)
    low = abi.lower_spec(_port_spec(sj))
    cuda_linalg.reset_launches()
    pt = dict(zip(NAMES, batch.fused_sweep(
        low, low.pad_conditions(_port_conds(cj)), low.pad_tof_mask(mask),
        device="cpu")))
    assert set(cuda_linalg.LAUNCHES.values()) == {0}
    pj = _jax_abi_fused(sj, cj, mask)
    assert pt["res"].x.shape == (L, low.static.n_species)
    assert np.array_equal(pt["res"].success.numpy(),
                          np.asarray(pj["res"].success))
    for name in ("quar", "cert", "amb", "neg", "bundle", "telemetry"):
        assert np.array_equal(pt[name].numpy(), np.asarray(pj[name])), name
    _envelope(pt["res"].x, pj["res"].x, "x")
    _envelope(pt["tofs"], pj["tofs"], "tofs")
    _envelope(pt["act"], pj["act"], "act")
    assert bool(pt["res"].success.all()) and bool(pt["cert"].all())


# ----------------------------------------------------------------------
# sweep_steady_state
def _jax_sweep(sj, cj, mask, use_abi, **kw):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv(precision.KERNEL_ENV, "pallas")
        mp.setenv(jabi.ABI_ENV, "1" if use_abi else "0")
        jbatch.clear_program_caches()
        jabi.clear_lowering_cache()
        try:
            out = jbatch.sweep_steady_state(sj, cj, tof_mask=mask, **kw)
            return {k: np.asarray(v) for k, v in out.items()}
        finally:
            jbatch.clear_program_caches()
            jabi.clear_lowering_cache()


def _assert_sweeps_agree(pt, pj):
    assert sorted(pt) == sorted(pj)
    for k in MASKS + INTS:
        if k in pj:
            got = pt[k].numpy()
            assert got.dtype == pj[k].dtype, k
            assert np.array_equal(got, pj[k]), k
    for k in ENVELOPE:
        if k in pj:
            assert pt[k].shape == pj[k].shape, k
            _envelope(pt[k], pj[k], k)
    # The normalized residual at an independently rounded converged
    # iterate is rounding noise; its decade rides in lane_telemetry.
    assert bool((pt["residual"] <= 1.0).all())
    assert np.all(pj["residual"] <= 1.0)


@pytest.mark.parametrize("use_abi,shape,check", [
    (False, (10, 5), True), (True, (10, 5), True), (True, (10, 5), False),
    (True, (24, 32), True)],
    ids=["10x5", "10x5-abi", "10x5-abi-nostab", "flagship-abi"])
def test_sweep_steady_state_matches_jax(use_abi, shape, check):
    """Without ABI the flagship's n = 21 takes Gauss-Jordan, where the
    JAX program does not reproduce itself to the envelope
    (test_torch_sweep.py holds that case); (10, 5) runs both routes."""
    sj, cj, mask = _case(*shape)
    pt = batch.sweep_steady_state(_port_spec(sj), _port_conds(cj), mask,
                                  check_stability=check, abi=use_abi,
                                  device="cpu")
    pj = _jax_sweep(sj, cj, mask, use_abi, check_stability=check)
    assert pt["y"].shape == (L, sj.n_species)
    assert ("stable" in pt) == check
    _assert_sweeps_agree(pt, pj)


def test_tier2_escalation_matches_jax(monkeypatch):
    """Ambiguous lanes go to the host eigensolve. The synthetic
    Jacobians keep their column-sum-zero conservation structure, so
    Gershgorin certifies every lane by itself; as the JAX package's
    ``test_tiered_screen.py`` does, the device-side tier-0 threshold
    (the call without ``eps``) is pinned far below any bound in both
    packages, while the host tier-2 threshold keeps the real formula."""
    sj, cj, mask = _case(10, 5)

    def never_certifies(orig):
        def f(scale, pos_tol=1e-2, eps=None):
            t = orig(scale, pos_tol, eps)
            return t - 2.0 * scale if eps is None else t
        return f

    monkeypatch.setattr(batch, "stability_tolerance_from_scale",
                        never_certifies(batch.stability_tolerance_from_scale))
    monkeypatch.setattr(jnewton, "stability_tolerance_from_scale",
                        never_certifies(jnewton.stability_tolerance_from_scale))
    sp, ct = _port_spec(sj), _port_conds(cj)
    low = abi.lower_spec(sp)
    outs = batch.fused_sweep(low, low.pad_conditions(ct),
                             low.pad_tof_mask(mask), device="cpu",
                             pos_tol=0.02)
    assert outs[-1].tolist()[:4] == [0, 0, L, L]     # every lane ambiguous
    pt = batch.sweep_steady_state(sp, ct, mask, check_stability=True,
                                  pos_jac_tol=0.02, abi=True, device="cpu")
    pj = _jax_sweep(sj, cj, mask, True, check_stability=True,
                    pos_jac_tol=0.02)
    assert bool(pt["stable"].all())
    _assert_sweeps_agree(pt, pj)


def test_abi_without_a_bucket_warns_and_runs_unpadded():
    sj, cj, mask = _case(12, 14)
    sp_big = _wide_arity(_port_spec(sj))
    with pytest.warns(UserWarning, match="does not fit any ABI bucket"):
        out = batch.sweep_steady_state(sp_big, _port_conds(cj), mask,
                                       abi=True, device="cpu")
    ref = batch.sweep_steady_state(sp_big, _port_conds(cj), mask,
                                   device="cpu")
    for k in ref:
        assert torch.equal(out[k], ref[k]), k


def test_mesh_is_not_ported():
    sj, cj, _ = _case(10, 5)
    with pytest.raises(NotImplementedError, match="Queue A item 12"):
        batch.sweep_steady_state(_port_spec(sj), _port_conds(cj),
                                 mesh=object(), device="cpu")
