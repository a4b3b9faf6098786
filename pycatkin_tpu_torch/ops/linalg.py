"""The dense-solve seam (PyTorch port of ``pycatkin_tpu/ops/linalg.py``).

:func:`select_solver` routes every dense solve by its size n exactly as
the JAX package's ``select_solver`` does under its Pallas kernel tier,
the tier a TPU resolves to; the path names are the JAX seam's:

- ``"pallas"``: n is one of the ABI bucket sizes :data:`KERNEL_BUCKETS`
  (the JAX package's ``PALLAS_BUCKETS``) -> the batched-LU kernels of
  :mod:`cuda_linalg`, ``lu_factor`` + ``lu_solve`` to factor once and
  solve many, ``factor_solve`` for a one-shot solve;
- ``"gauss"``: any other n <= :data:`UNROLL_MAX` -> row-equilibrated
  Gauss-Jordan in plain PyTorch: :func:`gauss_solve` for a one-shot
  solve, and to factor once the explicit inverse :func:`inv`, each
  right-hand side then a matvec (the JAX package's ``_make_inv_solve``;
  the Newton direction solve keeps one :func:`gauss_solve` per
  right-hand side, see ``solvers.newton._direction_factor``);
- ``"lu"``: anything larger -> the same :mod:`cuda_linalg` LU (the
  JAX package's sequential XLA LU does the same first-max
  partial-pivot arithmetic as its Pallas kernels).

The :mod:`cuda_linalg` wrappers launch the CUDA kernels on CUDA tensors
(at every n) and run their plain PyTorch versions on CPU tensors.

:func:`scaling_solve` keeps the scaling-relation solve off the seam, as
the JAX package does: Gauss-Jordan up to :data:`UNROLL_MAX`, LU beyond.
Shapes carry a leading lane dimension: ``A [L, n, n]``, ``b [L, n]`` or
``[L, n, k]``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import cuda_linalg

#: The static ABI bucket sizes the batched-LU kernels serve
#: (``pallas_linalg.PALLAS_BUCKETS`` of the JAX package).
KERNEL_BUCKETS = (16, 32, 128, 512)

#: Largest non-bucket n solved by Gauss-Jordan (``linalg.UNROLL_MAX``).
UNROLL_MAX = 48


class SolverChoice(NamedTuple):
    """One resolved solve path: ``path`` (``"pallas"`` | ``"gauss"`` |
    ``"lu"``), ``make_solve(M)`` factors once and returns a reusable
    solve closure, ``solve(A, b)`` is the one-shot solve."""
    path: str
    make_solve: Callable
    solve: Callable


def _make_lu_solve(M):
    LU, perm = cuda_linalg.lu_factor(M)
    return lambda r: cuda_linalg.lu_solve(LU, perm, r.contiguous())


def _lu_solve_once(A, b):
    return cuda_linalg.factor_solve(A, b.contiguous())


def _make_inv_solve(M):
    """Factor once by the explicit Gauss-Jordan inverse; each solve is
    then the matvec ``Minv @ r`` (``r``: ``[L, n]`` or ``[L, n, k]``)."""
    Minv = inv(M)

    def solve(r):
        if r.dim() == Minv.dim() - 1:
            return torch.matmul(Minv, r[..., None])[..., 0]
        return torch.matmul(Minv, r)
    return solve


def select_solver(n: int) -> SolverChoice:
    """The solve path for systems of size ``n`` (see the module doc)."""
    n = int(n)
    if n in KERNEL_BUCKETS:
        return SolverChoice("pallas", _make_lu_solve, _lu_solve_once)
    if n <= UNROLL_MAX:
        return SolverChoice("gauss", _make_inv_solve, gauss_solve)
    return SolverChoice("lu", _make_lu_solve, _lu_solve_once)


def make_msolve(M):
    """Factor ``M`` once and return a closure solving ``M x = r`` for
    each right-hand side it is given: the LU kernels on the bucket sizes
    and above :data:`UNROLL_MAX`, the explicit inverse below."""
    return select_solver(M.shape[-1]).make_solve(M)


def solve(A, b):
    """Solve ``A x = b`` for every lane."""
    return select_solver(A.shape[-1]).solve(A, b)


def gauss_solve(A, b):
    """Row-equilibrated, partial-pivoted Gauss-Jordan solve in plain
    PyTorch, term for term the arithmetic of the JAX package's
    ``linalg.gauss_solve``: the pivot row is picked with a one-hot
    matvec and exchanged by ``M - oh_p (row_p - row_k)``, which is not
    an exact swap for row p. Each ``M - f r`` update is ``addcmul``,
    which on the CPU rounds once, as XLA's CPU backend does when it
    contracts the update into a fused multiply-add, so on the CPU the
    result is bit for bit the JAX package's. ``A``: ``[L, n, n]``;
    ``b``: ``[L, n]`` or ``[L, n, k]``."""
    n = A.shape[-1]
    vec = b.dim() == A.dim() - 1
    B = b[..., None] if vec else b
    row_max = torch.amax(torch.abs(A), dim=-1, keepdim=True)
    r = torch.where(row_max > 0, 1.0 / row_max, torch.ones_like(row_max))
    M = torch.cat([A * r, B * r], dim=-1)
    idx = torch.arange(n, device=A.device)
    neg_inf = torch.tensor(-torch.inf, dtype=A.dtype, device=A.device)
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    # M is this function's own tableau, so it is updated in place.
    for k in range(n):
        col = torch.where(idx < k, neg_inf, torch.abs(M[:, :, k]))
        oh_p = (idx == torch.argmax(col, dim=1, keepdim=True)).to(A.dtype)
        row_k = M[:, k].clone()
        row_p = (oh_p[:, None, :] @ M)[:, 0]
        M[:, k] = row_p
        M.addcmul_(oh_p[:, :, None], (row_p - row_k)[:, None, :],
                   value=-1.0)
        row_k = M[:, k] / M[:, k, k, None]
        M[:, k] = row_k
        factors = torch.where(idx == k, zero, M[:, :, k])
        M.addcmul_(factors[:, :, None], row_k[:, None, :], value=-1.0)
    x = M[:, :, n:]
    return x[..., 0] if vec else x


def inv(A):
    """Inverse of every lane by Gauss-Jordan (``linalg.inv``)."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    return gauss_solve(A, eye.expand(A.shape[0], n, n))


def scaling_solve(A, b):
    """Knob-free solve for the scaling-relation system (a handful of
    descriptor states): Gauss-Jordan up to :data:`UNROLL_MAX`, LU
    beyond (``linalg.scaling_solve``)."""
    if A.shape[-1] <= UNROLL_MAX:
        return gauss_solve(A, b)
    return _lu_solve_once(A, b)
