"""The CUDA kernels on the card (marker ``cuda``; each test skips when no
CUDA device is present). Run on a card with

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which a card-only
machine need not have; this file imports neither JAX nor the JAX
package)."""

import numpy as np
import pytest
import torch

from pycatkin_tpu_torch.ops import cuda_linalg as cl

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _systems(lanes, n, k, device, seed=0, dtype=torch.float64):
    rng = np.random.default_rng(seed + n)
    A = rng.standard_normal((lanes, n, n)) + 2.0 * n * np.eye(n)
    for i in range(0, lanes, 3):
        A[i] = A[i][rng.permutation(n)]
    A[-1, :, n // 2] = 0.0                      # singular last lane
    b = rng.standard_normal((lanes, n) if k is None else (lanes, n, k))
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=device).to(
        dtype)
    return t(A), t(b)


@pytest.mark.parametrize("n", [1, 16, 21, 64, 112, 128])
@pytest.mark.parametrize("k", [None, 4], ids=["vec", "mat4"])
def test_kernels_match_plain_versions_on_the_card(device, n, k):
    A, b = _systems(65, n, k, device)
    cl.reset_launches()
    LU, perm = cl.lu_factor(A)
    x = cl.lu_solve(LU, perm, b)
    xf = cl.factor_solve(A, b)
    torch.cuda.synchronize()
    assert cl.LAUNCHES == {"lu_factor": 1, "lu_solve": 1, "factor_solve": 1}
    _hold_to_contract(A, b, LU, perm, x, xf, slice(0, 64))
    assert not bool(torch.isfinite(x[-1]).all())
    assert not bool(torch.isfinite(xf[-1]).all())


def _hold_to_contract(A, b, LU, perm, x, xf, good):
    """perm and LU the plain version's bit for bit, x within 1e-12
    relative (in float32 1e-12 eps32 / eps64, ~5.4e-4)."""
    LUr, permr = cl.lu_factor_ref(A)
    xr = cl.lu_solve_ref(LUr, permr, b)
    assert torch.equal(perm[good], permr[good])
    assert torch.equal(LU[good], LUr[good])
    scale = float(xr[good].abs().max())
    tol = 1e-12 * torch.finfo(A.dtype).eps / torch.finfo(torch.float64).eps
    assert float((x[good] - xr[good]).abs().max()) <= tol * scale
    assert float((xf[good] - xr[good]).abs().max()) <= tol * scale
    # Both solves take each entry's updates in the same order.
    assert torch.equal(x[good], xf[good])


@pytest.mark.parametrize("n", [165, 170, 200, 256, 512])
def test_kernels_serve_large_n_on_the_card(device, n):
    """Above n = 128: the panel tier factors the matrix in device memory
    (factor_solve through its workspace): at n = 165, whose lane fits
    shared memory but alone on an SM, and from n = 170, where it no
    longer fits, 200 with a last panel of 8 columns; perm and LU bit for
    bit the plain version's."""
    A, b = _systems(5, n, None, device)
    cl.reset_launches()
    LU, perm = cl.lu_factor(A)
    x = cl.lu_solve(LU, perm, b)
    xf = cl.factor_solve(A, b)
    torch.cuda.synchronize()
    assert cl.LAUNCHES == {"lu_factor": 1, "lu_solve": 1, "factor_solve": 1}
    _hold_to_contract(A, b, LU, perm, x, xf, slice(0, 4))
    assert not bool(torch.isfinite(x[-1]).all())
    assert not bool(torch.isfinite(xf[-1]).all())


@pytest.mark.parametrize("n", [1, 16, 21, 32, 64, 112, 128, 165, 170, 256,
                               512])
@pytest.mark.parametrize("k", [None, 4], ids=["vec", "mat4"])
def test_float32_kernels_match_plain_versions_on_the_card(device, n, k):
    """The float32 builds of the three kernels (``pk_*_f32``) at every
    tier: perm and LU the plain float32 version's bit for bit, x within
    1e-12 eps32 / eps64, lu_solve after lu_factor equal to factor_solve;
    only the float32 counters move."""
    lanes = 65 if n <= 128 else 5
    A, b = _systems(lanes, n, k, device, dtype=torch.float32)
    cl.reset_launches()
    LU, perm = cl.lu_factor(A)
    x = cl.lu_solve(LU, perm, b)
    xf = cl.factor_solve(A, b)
    torch.cuda.synchronize()
    assert LU.dtype == x.dtype == xf.dtype == torch.float32
    assert cl.LAUNCHES_F32 == {"lu_factor": 1, "lu_solve": 1,
                               "factor_solve": 1}
    assert set(cl.LAUNCHES.values()) == {0}
    _hold_to_contract(A, b, LU, perm, x, xf, slice(0, lanes - 1))
    assert not bool(torch.isfinite(x[-1]).all())
    assert not bool(torch.isfinite(xf[-1]).all())


def test_kernels_refuse_what_they_do_not_serve(device):
    """Float64 and float32 only, a right-hand side of the matrix's
    type."""
    A, b = _systems(2, 8, None, device)
    with pytest.raises(TypeError, match="float64 or float32"):
        cl.factor_solve(A[:, :4, :4].half().contiguous(), b[:, :4].half())
    with pytest.raises(TypeError, match="right-hand side of type"):
        cl.factor_solve(A.float(), b)


def test_sweep_on_the_card_matches_the_cpu(device):
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.models.synthetic import synthetic_spec
    from pycatkin_tpu_torch.parallel import batch

    spec, base = synthetic_spec(12, 14, seed=0)
    conds = batch.broadcast_conditions(base, 16)._replace(
        T=np.linspace(400.0, 800.0, 16))
    mask = engine.tof_mask_for(spec, [spec.rnames[-1]])
    cl.reset_launches()
    gpu = batch.fused_sweep(spec, conds, mask, device=device)
    # n_dyn = 9 takes Gauss-Jordan; the 64 x 64 Kronecker solve the LU.
    assert cl.LAUNCHES["lu_factor"] == 0 and cl.LAUNCHES["factor_solve"] > 0
    cpu = batch.fused_sweep(spec, conds, mask, device="cpu")
    for i in (1, 2, 3, 6, 8):
        assert torch.equal(gpu[i].cpu(), cpu[i]), i
    assert torch.equal(gpu[0].success.cpu(), cpu[0].success)
    assert torch.allclose(gpu[0].x.cpu(), cpu[0].x, rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("shape", [(24, 32), (10, 5)],
                         ids=["flagship", "10x5"])
def test_abi_sweep_on_the_card_matches_the_cpu(device, shape):
    """The ABI route: the flagship's D = 32 direction solves launch
    ``lu_factor`` + ``lu_solve``; both mechanisms' padded 16 x 16
    certificate launches ``factor_solve``."""
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.models.synthetic import synthetic_spec
    from pycatkin_tpu_torch.parallel import batch

    spec, base = synthetic_spec(*shape, seed=0)
    conds = batch.broadcast_conditions(base, 16)._replace(
        T=np.linspace(400.0, 800.0, 16))
    mask = engine.tof_mask_for(spec, [spec.rnames[-1]])
    kw = dict(check_stability=True, abi=True)
    cl.reset_launches()
    gpu = batch.sweep_steady_state(spec, conds, mask, device=device, **kw)
    assert cl.LAUNCHES["factor_solve"] > 0
    assert (cl.LAUNCHES["lu_factor"] > 0) == (shape == (24, 32))
    cpu = batch.sweep_steady_state(spec, conds, mask, device="cpu", **kw)
    for k in ("success", "stable", "quarantined", "iterations"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k
    assert torch.allclose(gpu["y"].cpu(), cpu["y"], rtol=1e-5, atol=1e-12)


def test_tier_sweep_on_the_card_matches_the_cpu(device):
    """The f32-polish tier through ``abi=True`` on the flagship (D = 32):
    the float32 march launches the float32 lu_factor / lu_solve, the
    float64 polish the float64 ones; verdicts, the strategy and tier
    columns equal to the same tier on the CPU, states within rtol 1e-5 /
    atol 1e-12, and the verdicts the float64 sweep's."""
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.models.synthetic import synthetic_spec
    from pycatkin_tpu_torch.parallel import batch

    spec, base = synthetic_spec(24, 32, seed=0)
    conds = batch.broadcast_conditions(base, 16)._replace(
        T=np.linspace(400.0, 800.0, 16))
    mask = engine.tof_mask_for(spec, [spec.rnames[-1]])
    kw = dict(check_stability=True, abi=True)
    cl.reset_launches()
    gpu = batch.sweep_steady_state(spec, conds, mask, device=device,
                                   tier="f32-polish", **kw)
    assert cl.LAUNCHES_F32["lu_factor"] > 0 and cl.LAUNCHES_F32["lu_solve"] > 0
    assert cl.LAUNCHES["lu_factor"] > 0
    cpu = batch.sweep_steady_state(spec, conds, mask, device="cpu",
                                   tier="f32-polish", **kw)
    ref = batch.sweep_steady_state(spec, conds, mask, device=device, **kw)
    for k in ("success", "stable", "quarantined"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k
        assert torch.equal(gpu[k], ref[k]), k
    assert torch.equal(gpu["lane_telemetry"][:, 3:].cpu(),
                       cpu["lane_telemetry"][:, 3:])
    assert torch.allclose(gpu["y"].cpu(), cpu["y"], rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("tier", ["f64", "f32-polish"])
def test_packed_sweep_on_the_card_matches_solo_sweeps(device, tier):
    """Three tenants of one bucket (synthetic (12, 14) seeds 0-2, D = 16)
    packed on the card: each tenant's result equal to its solo sweep on
    the card, key by key (bits), with one bundle pulled."""
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.models.synthetic import synthetic_spec
    from pycatkin_tpu_torch.parallel import batch
    from pycatkin_tpu_torch.solvers import newton

    ts = []
    for seed in range(3):
        spec, base = synthetic_spec(12, 14, seed=seed)
        conds = batch.broadcast_conditions(base, 16)._replace(
            T=np.linspace(430.0, 720.0, 16))
        ts.append((spec, conds, engine.tof_mask_for(spec,
                                                    [spec.rnames[-1]])))
    kw = dict(check_stability=True, device=device, tier=tier)
    solo = [batch.sweep_steady_state(s, c, m, abi=True, **kw)
            for s, c, m in ts]
    newton.reset_syncs()
    packed = batch.packed_sweep_steady_state(*(list(v) for v in zip(*ts)),
                                             **kw)
    assert newton.SYNCS["sweep_bundle"] == 1
    bits = lambda t: t.contiguous().view(torch.int64) \
        if t.dtype == torch.float64 else t
    for so, pa in zip(solo, packed):
        assert sorted(so) == sorted(pa)
        for key in so:
            assert torch.equal(bits(so[key]), bits(pa[key])), key


def test_large_mechanism_sweep_on_the_card_matches_the_cpu(device):
    """Synthetic (200, 200): n_dyn = 165 > 128, the LU route, on the
    card's kernels; 4 lanes against the CPU. Verdicts equal; states, TOF
    and activity within rtol 1e-5 / atol 1e-9 (chip_smoke.py's
    LARGE_ENVELOPE: the card's states sit ~4e-11 from the CPU's on this
    mechanism, its LU bit for bit); and the card's states pass the
    solver's convergence test evaluated on the CPU (normalized residual
    <= 1, plus the 1e-3 two evaluations of it may differ by)."""
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.models.synthetic import synthetic_spec
    from pycatkin_tpu_torch.parallel import batch
    from pycatkin_tpu_torch.solvers import newton

    spec, base = synthetic_spec(200, 200, seed=0)
    assert len(spec.dynamic_indices) == 165
    conds = batch.broadcast_conditions(base, 4)._replace(
        T=np.linspace(400.0, 800.0, 4))
    mask = engine.tof_mask_for(spec, [spec.rnames[-1]])
    cl.reset_launches()
    gpu = batch.fused_sweep(spec, conds, mask, device=device)
    assert cl.LAUNCHES["lu_factor"] > 0 and cl.LAUNCHES["lu_solve"] > 0
    cpu = batch.fused_sweep(spec, conds, mask, device="cpu")
    for i in (1, 2, 3, 6):
        assert torch.equal(gpu[i].cpu(), cpu[i]), i
    assert torch.equal(gpu[0].success.cpu(), cpu[0].success)
    assert bool(cpu[0].success.all())
    for g, c in ((gpu[0].x, cpu[0].x), (gpu[4], cpu[4]), (gpu[5], cpu[5])):
        assert torch.allclose(g.cpu(), c, rtol=1e-5, atol=1e-9)
    ds = engine.bind(spec, "cpu")
    ct = engine.conditions_to(conds, "cpu")
    kf, kr, _ = engine.rate_constants(ds, ct)
    F, gross = engine.closures(ds, ct, kf, kr).fscale(
        gpu[0].x.cpu()[:, list(spec.dynamic_indices)])
    rn = newton._rnorm(F, gross, newton.SolverOptions())
    assert float(rn.max()) <= 1.0 + 1e-3


def test_prng_on_the_card_matches_the_cpu(device):
    from pycatkin_tpu_torch.ops import prng

    keys = prng.split(prng.prng_key(0, device), 4096)
    keys_c = prng.split(prng.prng_key(0), 4096)
    assert torch.equal(keys.cpu(), keys_c)
    got = prng.uniform(prng.split(keys)[:, 1], (32,))
    assert torch.equal(got.cpu(), prng.uniform(prng.split(keys_c)[:, 1],
                                               (32,)))


ULP = 1.0 + 2.0 ** -52


def _one_ulp_runs(conds):
    """``conds`` with T up, T down and kscale up by one ulp."""
    return (conds._replace(T=conds.T * ULP), conds._replace(T=conds.T / ULP),
            conds._replace(kscale=conds.kscale * ULP))


def _hold(name, got, want, spreads):
    """The card's ``got`` within rtol 1e-5 / atol 1e-12 of the CPU's
    ``want``, or within twice the largest distance of the CPU's own
    one-ulp runs ``spreads`` from it (the rule of
    ``tests/test_torch_rescue.py``)."""
    got = got.cpu()
    if torch.allclose(got, want, rtol=1e-5, atol=1e-12):
        return
    own = max(float((s - want).abs().max()) for s in spreads)
    assert float((got - want).abs().max()) <= 2.0 * own, name


def _abi_flagship(lanes, device, perturb=None):
    """The ABI flagship on ``lanes`` lanes, T 400-800 K; ``perturb``
    maps the conditions before binding."""
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.frontend import abi
    from pycatkin_tpu_torch.models.synthetic import synthetic_spec
    from pycatkin_tpu_torch.parallel import batch

    spec, base = synthetic_spec(24, 32, seed=0)
    conds = batch.broadcast_conditions(base, lanes)._replace(
        T=np.linspace(400.0, 800.0, lanes))
    if perturb is not None:
        conds = perturb(conds)
    low = abi.lower_spec(spec)
    return (engine.bind(low, device),
            engine.conditions_to(low.pad_conditions(conds), device))


@pytest.mark.parametrize("strategy", ["ptc", "lm"])
def test_multi_attempt_solve_on_the_card_matches_the_cpu(device, strategy):
    """Three attempts of 20 steps from ``split(prng_key(0), L)`` on the ABI
    flagship (D = 32: ``lu_factor`` + ``lu_solve``): counts and verdicts
    equal to the CPU's; the converged states and, apart, the best
    unconverged ones (every LM lane) by :func:`_hold`."""
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.ops import prng
    from pycatkin_tpu_torch.solvers import newton

    opts = newton.SolverOptions(max_steps=20, max_attempts=3)

    def solve(dev, perturb=None):
        ds, ct = _abi_flagship(32, dev, perturb)
        return engine.steady_state(
            ds, ct, key=prng.split(prng.prng_key(0, dev), 32), opts=opts,
            strategy=strategy)

    cl.reset_launches()
    gpu = solve(device)
    assert cl.LAUNCHES["lu_factor"] > 0
    cpu = solve("cpu")
    for name in ("success", "attempts", "iterations", "rate_ok", "pos_ok",
                 "sums_ok"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    spreads = [solve("cpu", lambda c, i=i: _one_ulp_runs(c)[i]).x
               for i in range(3)]
    ok = cpu.success
    for lanes in (ok, ~ok):
        _hold("x", gpu.x[lanes.to(gpu.x.device)], cpu.x[lanes],
              [s[lanes] for s in spreads])


def test_rescue_ladder_on_the_card_matches_the_cpu(device):
    """The JAX package's failure corpus lowered into its bucket: 48 lanes,
    ``max_steps=6, max_attempts=2``; every lane fails the fast pass and
    goes through the ladder on the card's kernels. Verdicts, attempts
    and strategy codes equal to the CPU's. States, TOF and activity
    within rtol 1e-5 / atol 1e-12, or, where the polish lands a lane
    near the mechanism's sign change of TOF, within twice the spread of
    the CPU's own runs with T up, T down and kscale up one ulp (the rule
    of tests/test_torch_ladder.py); converged states pass the
    convergence test on the CPU."""
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.models.synthetic import synthetic_spec
    from pycatkin_tpu_torch.parallel import batch
    from pycatkin_tpu_torch.solvers import newton

    spec, base = synthetic_spec(24, 32, seed=0)
    conds = batch.broadcast_conditions(base, 48)._replace(
        T=np.linspace(400.0, 800.0, 48))
    mask = engine.tof_mask_for(spec, [spec.rnames[-1]])
    kw = dict(opts=newton.SolverOptions(max_steps=6, max_attempts=2),
              check_stability=True, abi=True)
    cl.reset_launches()
    gpu = batch.sweep_steady_state(spec, conds, mask, device=device, **kw)
    assert all(v > 0 for v in cl.LAUNCHES.values()), cl.LAUNCHES
    cpu = batch.sweep_steady_state(spec, conds, mask, device="cpu", **kw)
    for k in ("success", "stable", "quarantined", "attempts"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k
    assert torch.equal(gpu["lane_telemetry"][:, 3].cpu(),
                       cpu["lane_telemetry"][:, 3])
    assert bool((cpu["lane_telemetry"][:, 3] != 0).all())
    spreads = [batch.sweep_steady_state(spec, c, mask, device="cpu", **kw)
               for c in _one_ulp_runs(conds)]
    for k in ("y", "tof", "activity"):
        _hold(k, gpu[k], cpu[k], [s[k] for s in spreads])
    ds = engine.bind(spec, "cpu")
    ct = engine.conditions_to(conds, "cpu")
    kf, kr, _ = engine.rate_constants(ds, ct)
    F, gross = engine.closures(ds, ct, kf, kr).fscale(
        gpu["y"].cpu()[:, list(spec.dynamic_indices)])
    rn = newton._rnorm(F, gross, newton.SolverOptions())
    assert float(rn[cpu["success"]].max()) <= 1.0 + 1e-3


def test_rescue_rungs_on_the_card_match_the_cpu(device):
    """The ladder's later rungs on the failed lanes of a 25-step fast pass
    of the ABI flagship (32 lanes, five of which converge), at 40 steps
    and three attempts. Through ``batch._rescue``: the PTC rung seeded
    from the nearest converged lane (code 2; some lanes take all three
    attempts, the last from a threefry draw) and a demote round's
    unseeded PTC (seed 17, code 5), equal to the CPU's in codes, counts
    and verdicts, the recovered states within rtol 1e-5 / atol 1e-12.
    LM recovers no lane of this mechanism (nor in the JAX package), so
    its rung program is held as a whole: counts and verdicts equal, the
    best unconverged states by :func:`_hold`. ``lu_factor`` and
    ``lu_solve`` launched on the card."""
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.ops import prng
    from pycatkin_tpu_torch.parallel import batch
    from pycatkin_tpu_torch.solvers import newton

    opts = newton.SolverOptions(max_steps=40, max_attempts=3)
    fast_opts = batch.fast_pass_opts(newton.SolverOptions(max_steps=25))
    rungs = (("ptc", dict(neighbor_seed=True), newton.STRATEGY_CODES["ptc"]),
             ("ptc", dict(seed=17, use_x0=False),
              newton.STRATEGY_CODES["demote"]))

    def run(dev, perturb=None):
        ds, ct = _abi_flagship(32, dev, perturb)
        fast = engine.steady_state(ds, ct, opts=fast_opts)
        failed = torch.nonzero(~fast.success).flatten()
        lm = engine.steady_state(
            ds, engine.lane_subset(ct, failed), x0=fast.x[failed][:, ds.dyn],
            key=prng.split(prng.prng_key(1, dev), failed.numel()), opts=opts,
            strategy="lm")
        if perturb is not None:
            return lm
        out = []
        for strategy, kw, code in rungs:
            codes = np.zeros(32, dtype=np.int32)
            out.append(batch._rescue(ds, ct, fast, opts, strategy,
                                     codes=codes, code=code, **kw) + (codes,))
        return fast, lm, out

    cl.reset_launches()
    fast_g, lm_g, gpu = run(device)
    assert cl.LAUNCHES["lu_factor"] > 0 and cl.LAUNCHES["lu_solve"] > 0
    fast_c, lm_c, cpu = run("cpu")
    assert torch.equal(fast_g.success.cpu(), fast_c.success)
    assert 0 < int((~fast_c.success).sum()) < 32
    for (rg, lg, cg), (rc, lc, cc) in zip(gpu, cpu):
        assert lg == lc and np.array_equal(cg, cc)
        assert np.any(cc != 0)
        for name in ("success", "attempts", "iterations", "rate_ok",
                     "pos_ok", "sums_ok"):
            assert torch.equal(getattr(rg, name).cpu(), getattr(rc, name)), \
                name
        won = torch.as_tensor(cc != 0)
        assert torch.allclose(rg.x.cpu()[won], rc.x[won], rtol=1e-5,
                              atol=1e-12)
    assert int(cpu[0][0].attempts.max()) == 4
    for name in ("success", "attempts", "iterations", "rate_ok", "pos_ok",
                 "sums_ok"):
        assert torch.equal(getattr(lm_g, name).cpu(), getattr(lm_c, name)), \
            name
    assert not bool(lm_c.success.any())
    _hold("lm x", lm_g.x, lm_c.x,
          [run("cpu", lambda c, i=i: _one_ulp_runs(c)[i]).x
           for i in range(3)])


def bistable_port():
    """The JAX package's bistable test mechanism (``tests/test_verdicts.py``:
    ``s + 2 sa -> 3 sa`` at k1 = 10 and ``sa -> s`` at k2 = 1, 500 K, so
    ``da/dt = a (k1 a (1 - a) - k2)`` has stable roots at a = 0 and a ~
    0.8873 and an unstable one at a ~ 0.1127), built with the port's
    frontend. Returns ``(spec, conds, x0)``: three lanes starting on the
    unstable root, the stable one and a = 0."""
    from pycatkin_tpu_torch.constants import R, eVtokJ, h, kB
    from pycatkin_tpu_torch.frontend import reactions as rx
    from pycatkin_tpu_torch.frontend import spec as sp
    from pycatkin_tpu_torch.frontend import states as st
    from pycatkin_tpu_torch.models.reactor import InfiniteDilutionReactor
    from pycatkin_tpu_torch.parallel import batch

    T = 500.0

    def barrier(k):
        return -R * T * np.log(k * h / (kB * T)) / (eVtokJ * 1.0e3)

    s = st.State(name="s", state_type="surface")
    sa = st.State(name="sa", state_type="adsorbate")
    reactions = {r.name: r for r in (
        rx.UserDefinedReaction(name="r1", reac_type="arrhenius",
                               reversible=False, reactants=[s, sa, sa],
                               products=[sa, sa, sa], dGrxn_user=0.0,
                               dGa_fwd_user=barrier(10.0)),
        rx.UserDefinedReaction(name="r2", reac_type="arrhenius",
                               reversible=False, reactants=[sa],
                               products=[s], dGrxn_user=0.0,
                               dGa_fwd_user=barrier(1.0)))}
    reactor = InfiniteDilutionReactor()
    spec = sp.build_spec({"s": s, "sa": sa}, reactions,
                         reactor=reactor.reactor_type,
                         reactor_params=reactor.params())
    cond = sp.default_conditions(spec, reactions, T=T, p=1.0e5,
                                 start_state={"s": 1.0}, gelec_overrides={},
                                 eps={})
    roots = (10.0 - np.sqrt(60.0)) / 20.0, (10.0 + np.sqrt(60.0)) / 20.0, 0.0
    y = np.zeros((3, spec.n_species))
    y[:, spec.sindex("s")] = 1.0 - np.array(roots)
    y[:, spec.sindex("sa")] = roots
    return (spec, batch.broadcast_conditions(cond, 3),
            y[:, list(spec.dynamic_indices)])


def test_demote_loop_on_the_card_matches_the_cpu(device):
    """Lane 0 of the bistable mechanism starts on its unstable root,
    converges there, is demoted by the host eigensolve and re-solved
    unseeded (the demote rounds, seeds 17-19) onto a stable root, on the
    card as on the CPU: counts, verdicts and strategy codes equal, states
    within rtol 1e-5 / atol 1e-12."""
    from pycatkin_tpu_torch.parallel import batch
    from pycatkin_tpu_torch.solvers import newton

    spec, conds, x0 = bistable_port()
    gpu, cpu = (batch.sweep_steady_state(spec, conds, x0=x0,
                                         check_stability=True, device=dev)
                for dev in (device, "cpu"))
    for k in ("success", "stable", "quarantined", "attempts", "iterations",
              "lane_telemetry"):
        assert torch.equal(gpu[k].cpu(), cpu[k]), k
    assert int(cpu["lane_telemetry"][0, 3]) == newton.STRATEGY_CODES["demote"]
    assert bool(cpu["success"].all()) and bool(cpu["stable"].all())
    assert torch.allclose(gpu["y"].cpu(), cpu["y"], rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("max_steps", [4000, 5], ids=["whole", "finish"])
@pytest.mark.parametrize("use_abi", [False, True], ids=["unpadded", "abi"])
def test_transient_on_the_card_matches_the_cpu(device, use_abi, max_steps):
    """``batch_transient`` on synthetic (12, 14) seed 7, 4 lanes at T
    480-545 K, grid ``[0] + logspace(-9, -2, 9)``: unpadded, the stage
    matrices (n_s = 24) take the explicit Gauss-Jordan inverse and launch
    no kernel; through ``abi=True`` (S = 32) every step launches
    ``lu_factor`` and 13 ``lu_solve``. With the default 4,000 steps an
    interval every lane ends ``ok``; with 5 (``"finish"``) no lane
    reaches a save time, so all 4 go through the Newton finish (at D = 8
    through ``abi=True``, the Gauss-Jordan route), which rescues none.
    ``ok``, the diagnostics and the finish's lane count equal the CPU's;
    ``ys`` within rtol 1e-5 / atol 1e-12 of the CPU's, or within twice
    the CPU's own spread under a one-ulp change of T or kscale."""
    from pycatkin_tpu_torch.models.synthetic import synthetic_spec
    from pycatkin_tpu_torch.parallel import batch
    from pycatkin_tpu_torch.solvers import ode

    spec, base = synthetic_spec(12, 14, seed=7)
    conds = batch.broadcast_conditions(base, 4)._replace(
        T=np.linspace(480.0, 545.0, 4))
    grid = np.concatenate([[0.0], np.logspace(-9, -2, 9)])
    opts = ode.ODEOptions(max_steps=max_steps)

    def run(c, dev, diag=None):
        ode.reset_counters()
        out = batch.batch_transient(spec, c, grid, opts=opts, abi=use_abi,
                                    device=dev, diagnostics=diag)
        return out + (ode.FINISH["lanes"],)

    cl.reset_launches()
    diag, diag_c = {}, {}
    ys, ok, finished = run(conds, device, diag)
    torch.cuda.synchronize()
    steps = ode.SYNCS["ode_active"]
    if use_abi:
        assert cl.LAUNCHES["lu_factor"] > 0
        assert cl.LAUNCHES["lu_solve"] == 13 * cl.LAUNCHES["lu_factor"]
        assert cl.LAUNCHES["lu_factor"] <= steps
    else:
        assert set(cl.LAUNCHES.values()) == {0}
    ys_c, ok_c, finished_c = run(conds, "cpu", diag_c)
    assert torch.equal(ok.cpu(), ok_c)
    assert bool(ok_c.all() if max_steps == 4000 else ~ok_c.any())
    assert finished == finished_c == (0 if max_steps == 4000 else 4)
    assert diag == diag_c == {"failed": int((~ok_c).sum()),
                              "quarantined": 0}
    assert ys.shape == ys_c.shape == (4, len(grid), spec.n_species)
    if not torch.allclose(ys.cpu(), ys_c, rtol=1e-5, atol=1e-12):
        _hold("ys", ys, ys_c, [run(c, "cpu")[0]
                               for c in _one_ulp_runs(conds)])


def _drc_close(got, want, name):
    """xi within rtol 1e-6 / atol 1e-9, NaN lanes equal."""
    got = torch.as_tensor(np.asarray(got, dtype=float))
    want = torch.as_tensor(np.asarray(want, dtype=float))
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin), name
    assert torch.allclose(got[fin], want[fin], rtol=1e-6, atol=1e-9), name


def test_system_on_the_card_matches_the_cpu(device):
    """The facade on the toy mechanism of ``tests/torch_toy.py``:
    ``solve_odes``, ``find_steady`` and ``degree_of_rate_control`` (both
    modes) on the card against ``device="cpu"``."""
    from torch_toy import TOF, toy

    gpu, cpu = (toy("pycatkin_tpu_torch", device=d) for d in (device, "cpu"))
    for sim in (gpu, cpu):
        sim.solve_odes()
    assert torch.allclose(torch.as_tensor(gpu.solution),
                          torch.as_tensor(cpu.solution), rtol=1e-5,
                          atol=1e-12)
    rg, rc = gpu.find_steady(), cpu.find_steady()
    assert rg.x.device.type == "cuda"
    assert bool(rg.success) == bool(rc.success) is True
    assert torch.allclose(rg.x.cpu(), rc.x, rtol=1e-5, atol=1e-12)
    for mode in ("implicit", "fd"):
        dg = gpu.degree_of_rate_control(TOF, mode=mode)
        dc = cpu.degree_of_rate_control(TOF, mode=mode)
        _drc_close(list(dg.values()), list(dc.values()), mode)


def test_run_temperatures_on_the_card_matches_the_cpu(device):
    """A 4-lane ``run_temperatures`` with the steady solve and the
    implicit DRC on the card against the CPU."""
    from pycatkin_tpu_torch.api import presets
    from torch_toy import TOF, toy

    Ts = [460.0, 500.0, 540.0, 580.0]
    outs = [presets.run_temperatures(toy("pycatkin_tpu_torch", device=d),
                                     Ts, steady_state_solve=True,
                                     tof_terms=TOF) for d in (device, "cpu")]
    (fg, rg, dg), (fc, rc, dc) = outs
    assert np.allclose(fg, fc, rtol=1e-5, atol=1e-12)
    assert np.allclose(rg, rc, rtol=1e-5, atol=1e-10)
    for T in Ts:
        _drc_close(list(dg[T].values()), list(dc[T].values()), f"T={T}")


def test_drc_at_n165_on_the_card_matches_the_cpu(device):
    """``engine.drc`` on 4 lanes of synthetic (200, 200) (n_dyn = 165)
    from the card's sweep states: ``factor_solve`` launches three times
    (two polish steps and the adjoint solve); the CPU run from the same
    states has the same NaN lanes (the constrained Jacobian of this
    mechanism hits exact zero pivots on most lanes) and the same finite
    xi."""
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.models.synthetic import synthetic_spec
    from pycatkin_tpu_torch.parallel import batch

    spec, base = synthetic_spec(200, 200, seed=0)
    conds = batch.broadcast_conditions(base, 4)._replace(
        T=np.linspace(420.0, 780.0, 4))
    out = batch.fused_sweep(spec, conds, device=device)
    x0 = out[0].x[:, list(spec.dynamic_indices)]
    terms = [spec.rnames[-1]]
    xis = []
    for dev in (device, "cpu"):
        ds = engine.bind(spec, dev)
        ct = engine.conditions_to(conds, dev)
        cl.reset_launches()
        xis.append(engine.drc(ds, ct, terms, x0=x0.to(dev)).cpu())
        if dev == device:
            torch.cuda.synchronize()
            assert cl.LAUNCHES["factor_solve"] == 3, cl.LAUNCHES
    assert xis[0].shape == (4, spec.n_reactions)
    _drc_close(xis[0].numpy(), xis[1].numpy(), "xi")


def test_packed_transient_on_the_card_matches_solo_transients(device):
    """``packed_batch_transient`` of two tenants of bucket 32 (synthetic
    (12, 14) seeds 1 and 4, 4 lanes each at T 480-545 K + 2 seed, grid
    ``[0] + logspace(-9, -2, 9)``) on the card: each tenant bit for bit
    its solo ``batch_transient(abi=True)`` on the card, one
    ``lu_factor`` launch per batch step of the pack (fewer than the two
    solo runs' sum), and ``ok`` equal to the CPU's solo runs."""
    from pycatkin_tpu_torch.models.synthetic import synthetic_spec
    from pycatkin_tpu_torch.parallel import batch
    from pycatkin_tpu_torch.solvers import ode

    grid = np.concatenate([[0.0], np.logspace(-9, -2, 9)])
    tenants = []
    for seed in (1, 4):
        spec, base = synthetic_spec(12, 14, seed=seed)
        tenants.append((spec, batch.broadcast_conditions(base, 4)._replace(
            T=np.linspace(480.0, 545.0, 4) + 2.0 * seed)))
    solo, solo_lu = [], 0
    for spec, conds in tenants:
        cl.reset_launches()
        solo.append(batch.batch_transient(spec, conds, grid, abi=True,
                                          device=device))
        torch.cuda.synchronize()
        solo_lu += cl.LAUNCHES["lu_factor"]
    cl.reset_launches()
    ode.reset_counters()
    packed = batch.packed_batch_transient([t[0] for t in tenants],
                                          [t[1] for t in tenants], grid,
                                          device=device)
    torch.cuda.synchronize()
    assert 0 < cl.LAUNCHES["lu_factor"] <= ode.SYNCS["ode_active"]
    assert cl.LAUNCHES["lu_factor"] < solo_lu
    for (spec, conds), (ys_s, ok_s), (ys_p, ok_p) in zip(tenants, solo,
                                                         packed):
        assert ys_p.device.type == "cuda"
        assert torch.equal(ys_s.view(torch.int64), ys_p.view(torch.int64))
        assert torch.equal(ok_s, ok_p)
        _, ok_c = batch.batch_transient(spec, conds, grid, abi=True,
                                        device="cpu")
        assert torch.equal(ok_p.cpu(), ok_c)


def test_server_on_the_card_answers_as_solo_calls(device):
    """The sweep server on the card, in process: two bucket-16 sweeps
    ride one packed flush and two same-grid transients another, each
    answer byte for byte its solo call on the card; the sweep verdicts
    equal the CPU's; the manifest names the card and the kernel
    library, and no flush builds it after the warm-up."""
    import asyncio
    import json

    from pycatkin_tpu_torch.models.synthetic import \
        synthetic_system_for_bucket
    from pycatkin_tpu_torch.parallel import batch
    from pycatkin_tpu_torch.serve import (ServeConfig, SweepClient,
                                          SweepServer)
    from pycatkin_tpu_torch.serve.protocol import jsonable
    from pycatkin_tpu_torch.serve.server import SUMMARY_KEYS

    sims = [synthetic_system_for_bucket(16, seed=s) for s in (1, 4)]
    T = [500.0, 520.0]
    ts = [0.0, 1e-7, 1e-5, 1e-3]

    async def scenario():
        server = await SweepServer(ServeConfig()).start(listen=False)
        try:
            warm = await asyncio.to_thread(server.warm, sims, len(T), (2,),
                                           ts)
            server.mark_warm()
            client = SweepClient(server)
            resps = await asyncio.gather(*(
                [client.sweep(s, T, wait_budget_s=5.0) for s in sims]
                + [client.transient(s, T, ts, wait_budget_s=5.0)
                   for s in sims]))
            return warm, resps, server.stats(), server.boot_manifest
        finally:
            await server.drain()

    warm, resps, stats, manifest = asyncio.run(scenario())
    assert manifest["backend"]["platform"] == "gpu"
    assert manifest["kernel_library"]
    assert warm["compiled"] + warm["loaded"] <= 1
    assert stats["zero_compile_rate_after_warm"] == 1.0
    assert [r["pack"]["tenants"] for r in resps] == [2, 2, 2, 2]
    for sim, resp in zip(sims + sims, resps):
        conds = batch.stack_conditions([sim.conditions(T=t, p=1e5)
                                        for t in T])
        if "save_points" in resp:
            ys, ok = batch.batch_transient(sim.spec, conds, ts, abi=True,
                                           device=device)
            want = {"ok": ok.cpu().numpy(),
                    "endpoint": ys[:, -1, :].cpu().numpy()}
        else:
            out = batch.sweep_steady_state(sim.spec, conds, abi=True,
                                           device=device)
            want = {k: out[k].cpu().numpy() for k in SUMMARY_KEYS
                    if k in out}
            cpu = batch.sweep_steady_state(sim.spec, conds, abi=True,
                                           device="cpu")
            assert resp["result"]["success"] == cpu["success"].tolist()
        assert json.dumps(resp["result"]) == json.dumps(jsonable(want))


def _flagship_lanes(lanes):
    from pycatkin_tpu_torch import engine
    from pycatkin_tpu_torch.models.synthetic import synthetic_system
    from pycatkin_tpu_torch.parallel import batch
    sim = synthetic_system(24, 32, seed=0)
    conds = batch.broadcast_conditions(sim.conditions(), lanes)._replace(
        T=np.linspace(400.0, 800.0, lanes))
    return sim, conds, engine.tof_mask_for(sim.spec, [sim.spec.rnames[-1]])


def _same(a, b):
    return sorted(a) == sorted(b) and all(
        np.array_equal(a[k], b[k], equal_nan=True) for k in a)


def test_chunked_sweep_on_the_card_resumes_bit_for_bit(device, tmp_path):
    """``chip_smoke.py`` phase 17a at 4,096 lanes: no rung fires on the
    undisturbed run, the pipelined loop equals the serial one, and a
    resume of a faulted run (transient, permanent and NaN faults) equals
    the undisturbed run."""
    from pycatkin_tpu_torch.obs import metrics
    from pycatkin_tpu_torch.robustness import (DegradationPolicy, FaultPlan,
                                               chunked_sweep_steady_state,
                                               fault_scope)
    sim, conds, mask = _flagship_lanes(4096)
    kw = dict(chunk=1024, tof_mask=mask, check_stability=True, abi=True,
              device=device)
    rungs = lambda: metrics.counter("pycatkin_ladder_rung_total").values()
    r0 = rungs()
    out1, rep1 = chunked_sweep_steady_state(
        sim.spec, conds, journal=str(tmp_path / "j1"), **kw)
    assert rungs() == r0 and rep1["events"] == []
    piped, _ = chunked_sweep_steady_state(sim.spec, conds, pipeline=True,
                                          **kw)
    assert _same(out1, piped)
    plan = FaultPlan([
        {"site": "chunk:1", "kind": "transient", "times": 1},
        {"site": "chunk:2", "kind": "permanent", "times": None},
        {"site": "batched steady solve", "kind": "nan", "index": 2,
         "lanes": [3, 500], "times": 1},
        {"site": "rescue*", "kind": "nan", "times": None}])
    policy = DegradationPolicy(host_fallback=False, base_delay_s=0.01,
                               max_delay_s=0.05)
    with fault_scope(plan):
        _, rep2 = chunked_sweep_steady_state(
            sim.spec, conds, journal=str(tmp_path / "j2"), policy=policy,
            **kw)
    assert rep2["salvaged"] == [2] and 3 in rep2["quarantined"]
    out3, rep3 = chunked_sweep_steady_state(
        sim.spec, conds, journal=str(tmp_path / "j2"), resume=True, **kw)
    redo = set(rep2["salvaged"]) | set(rep2["quarantined"])
    assert rep3["reused"] == sorted(set(range(4)) - redo)
    assert _same(out3, out1)


def test_worker_modes_on_the_card_match_in_process(device, tmp_path):
    """``chip_smoke.py`` phase 17b at 1,024 lanes: the elastic sweep (two
    workers on the card, one crashed) and the static one each equal the
    in-process chunked sweep of their chunk grid on the card, bit for
    bit."""
    from pycatkin_tpu_torch.parallel import dispatch
    from pycatkin_tpu_torch.robustness import (chunked_sweep_steady_state,
                                               run_elastic)
    sim, conds, mask = _flagship_lanes(1024)
    terms = [sim.spec.rnames[-1]]
    eout, erep = run_elastic(
        sim, conds, n_workers=2, chunk=256, work_dir=str(tmp_path / "w"),
        tof_terms=terms, check_stability=True, abi=True, ttl_s=60.0,
        heartbeat_s=2.0, restart_base_s=0.2, restart_max_s=1.0,
        timeout=300.0,
        fault_plan={"specs": [{"site": "worker:0", "kind": "worker-crash",
                               "times": 1}],
                    "state_dir": str(tmp_path / "faults")})
    kw = dict(tof_mask=mask, check_stability=True, abi=True, device=device)
    ref, _ = chunked_sweep_steady_state(sim.spec, conds, chunk=256, **kw)
    assert _same(eout, ref) and erep["restarts"] >= 1
    sout = dispatch.dispatch_sweep(sim, conds, n_workers=2, tof_terms=terms,
                                   check_stability=True, abi=True,
                                   timeout=300.0)
    ref, _ = chunked_sweep_steady_state(sim.spec, conds, chunk=512, **kw)
    assert _same(sout, ref)


@pytest.mark.parametrize("opt_in", [False, True])
def test_kernel_launch_failure_in_a_chunk_propagates(device, monkeypatch,
                                                      opt_in):
    """A kernel launch that fails inside a chunk leaves the chunked sweep
    as ``KernelError``: no rung re-runs the chunk on the CPU, not even
    under a policy that opts the card run in to the host fallback."""
    from pycatkin_tpu_torch.robustness import (DegradationPolicy,
                                               chunked_sweep_steady_state)
    from pycatkin_tpu_torch.utils import profiling
    sim, conds, mask = _flagship_lanes(64)
    cl.load()
    monkeypatch.setattr(cl, "_entry", lambda name, dtype: (
        lambda *args: 700))                     # cudaErrorIllegalAddress
    policy = DegradationPolicy(host_fallback=opt_in, base_delay_s=0.01,
                               max_delay_s=0.05)
    profiling.drain_events()
    with pytest.raises(cl.KernelError, match="launch failed"):
        chunked_sweep_steady_state(sim.spec, conds, chunk=32, tof_mask=mask,
                                   abi=True, device=device, policy=policy)
    assert not profiling.peek_events("degradation")


@pytest.mark.parametrize("method", ["trbdf2", "esdirk4"])
def test_chunked_transient_on_the_card_matches_fused(device, method):
    """``chip_smoke.py`` phase 17c at 64 lanes: the chunked route equals
    the fused route bit for bit."""
    from pycatkin_tpu_torch.parallel import batch
    from pycatkin_tpu_torch.solvers import ode
    sim, conds, _ = _flagship_lanes(64)
    ts = [0.0, 1e-9, 1e-7, 1e-5, 1e-3, 1e-1]
    opts = ode.ODEOptions(method=method)
    fused = batch.batch_transient(sim.spec, conds, ts, opts=opts, abi=True,
                                  device=device)
    chunked = batch.batch_transient(sim.spec, conds, ts, opts=opts,
                                    abi=True, device=device, fused=False,
                                    chunk=2, force_chunking=True)
    assert torch.equal(fused[0], chunked[0])
    assert torch.equal(fused[1], chunked[1])
