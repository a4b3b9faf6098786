"""The kernels' plain PyTorch versions (``cuda_linalg.*_ref``, what the
wrappers run on CPU tensors) against the JAX package's Pallas kernels in
interpret mode (``jax.vmap(pallas_linalg.*)``) and its XLA LU
(``linalg.lu_factor`` / ``lu_solve`` / ``_lu_solve_once``).

Contract: perm exactly equal; LU and x within 1e-12 relative to the
lane batch's largest magnitude -- the arithmetic is the same and only
the order of the row-dot sums differs (docs/perf_pallas_linalg.md).
``_lu_solve_once`` is ``lu_solve(*lu_factor(A), b)``, so the one-shot
solves are held against that composition.
A singular lane comes out non-finite and leaves its neighbours equal to
their solo runs; CPU tensors never launch a kernel."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycatkin_tpu import precision
from pycatkin_tpu.ops import linalg as jlinalg
from pycatkin_tpu.ops import pallas_linalg as plk
from pycatkin_tpu.solvers import newton as jnewton
from pycatkin_tpu_torch.ops import cuda_linalg as cl
from pycatkin_tpu_torch.ops import linalg
from pycatkin_tpu_torch.solvers import newton

TOL = 1e-12
LANES = 8


def _systems(n, k=None, seed=0, lanes=LANES):
    """Well-conditioned, row-shuffled systems (pivoting is exercised)."""
    rng = np.random.default_rng(seed + 100 * n)
    A = rng.standard_normal((lanes, n, n)) + 2.0 * n * np.eye(n)
    for i in range(0, lanes, 2):
        A[i] = A[i][rng.permutation(n)]
    b = rng.standard_normal((lanes, n) if k is None else (lanes, n, k))
    return A, b


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b)) / np.max(np.abs(b)))


def _t(a):
    return torch.tensor(a, dtype=torch.float64)


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("k", [None, 4], ids=["vec", "mat4"])
def test_plain_versions_match_pallas_kernels(n, k):
    A, b = _systems(n, k)
    LUj, pj = jax.vmap(plk.lu_factor)(jnp.asarray(A))
    xj = jax.vmap(plk.lu_solve)(LUj, pj, jnp.asarray(b))
    fj = jax.vmap(plk.factor_solve)(jnp.asarray(A), jnp.asarray(b))
    LUt, pt = cl.lu_factor_ref(_t(A))
    assert pt.dtype == torch.int32
    assert np.array_equal(pt.numpy(), np.asarray(pj))
    assert _rel(LUt, LUj) <= TOL
    assert _rel(cl.lu_solve_ref(LUt, pt, _t(b)), xj) <= TOL
    assert _rel(cl.factor_solve_ref(_t(A), _t(b)), fj) <= TOL


@pytest.mark.parametrize("n", [21, 64])
@pytest.mark.parametrize("k", [None, 4], ids=["vec", "mat4"])
def test_plain_versions_match_xla_lu(n, k):
    A, b = _systems(n, k, seed=3)
    # unroll=1: the same column steps and row recurrences as the
    # default chunk-unrolled loops, at a fraction of the compile time.
    def ref(A, b):
        LU, p = jlinalg.lu_factor(A, unroll=1)
        return LU, p, jlinalg.lu_solve(LU, p, b, unroll=1)
    LUj, pj, xj = jax.jit(jax.vmap(ref))(jnp.asarray(A), jnp.asarray(b))
    LUt, pt = cl.lu_factor(_t(A))
    assert np.array_equal(pt.numpy(), np.asarray(pj))
    assert _rel(LUt, LUj) <= TOL
    assert _rel(cl.lu_solve(LUt, pt, _t(b)), xj) <= TOL
    assert _rel(cl.factor_solve(_t(A), _t(b)), xj) <= TOL
    # The seam routes as the JAX package's direction solve: n = 64 by LU
    # (the composition above), n = 21 by one Gauss-Jordan solve per
    # right-hand side, the factor-once closure too.
    if jlinalg.select_solver(n).path == "gauss":
        sj = jax.jit(jax.vmap(jlinalg.gauss_solve))(jnp.asarray(A),
                                                    jnp.asarray(b))
    else:
        sj = xj
    assert _rel(linalg.solve(_t(A), _t(b)), sj) <= TOL
    assert _rel(linalg.make_msolve(_t(A))(_t(b)), sj) <= TOL


@pytest.mark.parametrize("n", [5, 21])
def test_singular_lane_is_nonfinite_and_isolated(n):
    A, b = _systems(n, seed=9)
    A[3, :, n // 2] = 0.0           # exactly singular
    A[5, 1, 1] = np.nan             # poisoned
    At, bt = _t(A), _t(b)
    LU, perm = cl.lu_factor(At)
    x = cl.lu_solve(LU, perm, bt)
    xf = cl.factor_solve(At, bt)
    for bad in (3, 5):
        assert not bool(torch.isfinite(x[bad]).all())
        assert not bool(torch.isfinite(xf[bad]).all())
    for lane in (0, 1, 2, 4, 6, 7):
        LU1, p1 = cl.lu_factor(At[lane:lane + 1])
        assert torch.equal(LU1[0], LU[lane]) and torch.equal(p1[0],
                                                             perm[lane])
        assert torch.equal(cl.lu_solve(LU1, p1, bt[lane:lane + 1])[0],
                           x[lane])
        assert torch.equal(cl.factor_solve(At[lane:lane + 1],
                                           bt[lane:lane + 1])[0], xf[lane])
        assert bool(torch.isfinite(x[lane]).all())


def test_cpu_tensors_launch_no_kernel():
    cl.reset_launches()
    A, b = _systems(16, 2)
    LU, perm = cl.lu_factor(_t(A))
    cl.lu_solve(LU, perm, _t(b))
    cl.factor_solve(_t(A), _t(b))
    linalg.solve(_t(A), _t(b))
    assert cl.LAUNCHES == {"lu_factor": 0, "lu_solve": 0, "factor_solve": 0}


def test_wrappers_check_their_arguments():
    A, b = _systems(4)
    At, bt = _t(A), _t(b)
    with pytest.raises(TypeError, match="float64 or float32"):
        cl.lu_factor(At.half())
    with pytest.raises(TypeError, match="right-hand side of type"):
        cl.factor_solve(At.float(), bt)
    with pytest.raises(ValueError, match="lanes, n, n"):
        cl.lu_factor(At[0])
    with pytest.raises(ValueError, match="contiguous"):
        cl.lu_factor(At.transpose(1, 2))
    with pytest.raises(ValueError, match="right-hand side"):
        cl.factor_solve(At, bt[:, :3])
    LU, perm = cl.lu_factor(At)
    with pytest.raises(ValueError, match="perm"):
        cl.lu_solve(LU, perm.long(), bt)


def test_select_solver_policy(monkeypatch):
    """The seam picks the JAX package's path for every n under the
    Pallas tier (the TPU's); the wrappers then take the plain version
    for CPU tensors and the kernel for CUDA tensors, at every n."""
    monkeypatch.setenv(precision.KERNEL_ENV, "pallas")
    for n in list(range(1, 131)) + [256, 512]:
        assert linalg.select_solver(n).path == \
            jlinalg.select_solver(n).path, n
    assert [n for n in range(1, 513)
            if linalg.select_solver(n).path == "pallas"] == [16, 32, 128,
                                                             512]
    lane = lambda dev, n: SimpleNamespace(device=torch.device(dev),
                                          shape=(1, n, n))
    for n in (1, 32, 128, 129, 165, 256, 512):
        assert cl._route("lu_factor", lane("cpu", n)) is False
        assert cl._route("factor_solve", lane("cuda", n)) is True
    with pytest.raises(ValueError, match="unsupported device"):
        cl._route("lu_solve", lane("meta", 4))
    # The CPU path has no size limit either (plain versions).
    A, b = _systems(130, lanes=1, seed=5)
    x = linalg.solve(_t(A), _t(b))
    assert _rel(x, np.linalg.solve(A, b[..., None])[..., 0]) <= 1e-10


@pytest.mark.parametrize("n", [5, 21, 48])
def test_gauss_jordan_route_matches_jax(n):
    """Below 49, off the buckets: ``make_msolve`` is the JAX package's,
    the explicit inverse (bit for bit its ``inv``) and then one matvec
    per right-hand side, which XLA's CPU backend and ``torch.matmul``
    sum in different orders: each entry within two n-term summation
    error bounds, ``2 n eps (|Minv| @ |r|)``. The PTC direction solve
    (``newton._direction_factor``) keeps the JAX package's own branch,
    one ``gauss_solve`` per right-hand side, bit for bit, and no kernel
    is launched."""
    A, b = _systems(n, seed=11)
    A *= 10.0 ** np.random.default_rng(n).uniform(-12, 12, (LANES, n, 1))
    cl.reset_launches()
    Aj = jnp.asarray(A)
    inv_j = jax.jit(jax.vmap(jlinalg.inv))(Aj)
    assert np.array_equal(linalg.inv(_t(A)).numpy(), np.asarray(inv_j))
    assert linalg.select_solver(n).path == "gauss"
    B = np.stack([b, 2.0 * b], axis=-1)
    solve = linalg.make_msolve(_t(A))
    direction = newton._direction_factor(_t(A))
    absinv = np.abs(np.asarray(inv_j))
    # The JAX package's make_msolve on this path is the inverse, then
    # ``Minv @ r`` (its matvec is taken on the inverse computed above).
    assert jlinalg.select_solver(n).make_solve is jlinalg._make_inv_solve
    matvec = jax.jit(jax.vmap(lambda Mi, r: Mi @ r))
    for rhs in (b, B):
        rj = jnp.asarray(rhs)
        want = np.asarray(matvec(inv_j, rj))
        r2 = rhs if rhs.ndim == 3 else rhs[..., None]
        bound = 2.0 * n * np.finfo(np.float64).eps * (absinv @ np.abs(r2))
        got = solve(_t(rhs)).numpy()
        assert got.shape == want.shape
        assert np.all(np.abs(got - want) <= bound.reshape(want.shape))
        want_d = jax.jit(jax.vmap(lambda M, r: jnewton._direction_factor(
            M, jnewton.SolverOptions())(r)))(Aj, rj)
        assert np.array_equal(direction(_t(rhs)).numpy(), np.asarray(want_d))
    assert cl.LAUNCHES == {"lu_factor": 0, "lu_solve": 0, "factor_solve": 0}


@pytest.mark.parametrize("k", [None, 3], ids=["vec", "mat3"])
def test_gauss_solve_matches_jax(k):
    A, b = _systems(5, k, seed=7)
    xj = jax.jit(jax.vmap(jlinalg.gauss_solve))(jnp.asarray(A),
                                                jnp.asarray(b))
    assert _rel(linalg.gauss_solve(_t(A), _t(b)), xj) <= TOL
    assert _rel(linalg.scaling_solve(_t(A), _t(b)), xj) <= TOL
    assert np.array_equal(linalg.gauss_solve(_t(A), _t(b)).numpy(),
                          np.asarray(xj))
