"""The dense-solve seam (PyTorch port of ``pycatkin_tpu/ops/linalg.py``).

Every direction solve of the steady solver goes through
:func:`make_msolve` (``lu_factor`` + ``lu_solve``, factor once / solve
many) and every one-shot solve through :func:`solve` (``factor_solve``).
The :mod:`cuda_linalg` wrappers alone pick the path: the hand-written
CUDA kernels for CUDA tensors with n <= 128 (every n in that range, no
bucket padding), ``NotImplementedError`` above that (the blocked kernel
for bucket 512 is ROADMAP Queue B item 4), and the kernels' plain
PyTorch versions for CPU tensors.

:func:`scaling_solve` stays plain PyTorch (:func:`gauss_solve`) on every
device, as the JAX package keeps the scaling-relation solve off its
kernel seam. Shapes carry a leading lane dimension: ``A [L, n, n]``,
``b [L, n]`` or ``[L, n, k]``.
"""

from __future__ import annotations

import torch

from . import cuda_linalg


def make_msolve(M):
    """Factor ``M`` once, return a closure solving ``M x = r`` for each
    right-hand side it is given."""
    LU, perm = cuda_linalg.lu_factor(M)
    return lambda r: cuda_linalg.lu_solve(LU, perm, r)


def solve(A, b):
    """Solve ``A x = b`` for every lane in one ``factor_solve`` call."""
    return cuda_linalg.factor_solve(A, b)


def gauss_solve(A, b):
    """Row-equilibrated, partial-pivoted Gauss-Jordan solve in plain
    PyTorch (``linalg.gauss_solve`` of the JAX package). ``A``:
    ``[L, n, n]``; ``b``: ``[L, n]`` or ``[L, n, k]``."""
    n = A.shape[-1]
    vec = b.dim() == A.dim() - 1
    B = b[..., None] if vec else b
    row_max = torch.amax(torch.abs(A), dim=-1, keepdim=True)
    r = torch.where(row_max > 0, 1.0 / row_max, torch.ones_like(row_max))
    M = torch.cat([A * r, B * r], dim=-1)
    lanes = torch.arange(M.shape[0], device=M.device)
    for k in range(n):
        col = torch.abs(M[:, k:, k])
        p = k + torch.argmax(col, dim=1)
        rk, rp = M[lanes, k].clone(), M[lanes, p].clone()
        M[lanes, k] = rp
        M[lanes, p] = rk
        row_k = M[:, k] / M[:, k, k, None]
        M[:, k] = row_k
        factors = M[:, :, k].clone()
        factors[:, k] = 0.0
        M = M - factors[:, :, None] * row_k[:, None, :]
    x = M[:, :, n:]
    return x[..., 0] if vec else x


def scaling_solve(A, b):
    """Knob-free solve for the scaling-relation system (a handful of
    descriptor states): always :func:`gauss_solve`."""
    return gauss_solve(A, b)
