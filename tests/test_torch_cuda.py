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


def _systems(lanes, n, k, device, seed=0):
    rng = np.random.default_rng(seed + n)
    A = rng.standard_normal((lanes, n, n)) + 2.0 * n * np.eye(n)
    for i in range(0, lanes, 3):
        A[i] = A[i][rng.permutation(n)]
    A[-1, :, n // 2] = 0.0                      # singular last lane
    b = rng.standard_normal((lanes, n) if k is None else (lanes, n, k))
    t = lambda a: torch.tensor(a, dtype=torch.float64, device=device)
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
    LUr, permr = cl.lu_factor_ref(A)
    xr = cl.lu_solve_ref(LUr, permr, b)
    assert torch.equal(perm[good], permr[good])
    assert torch.equal(LU[good], LUr[good])
    scale = float(xr[good].abs().max())
    assert float((x[good] - xr[good]).abs().max()) <= 1e-12 * scale
    assert float((xf[good] - xr[good]).abs().max()) <= 1e-12 * scale
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


def test_kernels_refuse_what_they_do_not_serve(device):
    A, b = _systems(2, 8, None, device)
    with pytest.raises(TypeError, match="float64"):
        cl.factor_solve(A[:, :4, :4].float().contiguous(), b[:, :4].float())


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
