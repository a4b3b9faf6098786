"""Batched LU kernels for the direction and certificate solves, with their
plain PyTorch versions.

Port of ``pycatkin_tpu/ops/pallas_linalg.py``. The three Pallas kernels
there become hand-written CUDA kernels for Hopper (``csrc/linalg.cu``):

==============  ====================================================
wrapper         replaces
==============  ====================================================
lu_factor       ``pallas_linalg.lu_factor`` (``_lu_kernel`` +
                ``_factor_body``)
lu_solve        ``pallas_linalg.lu_solve`` (``_lu_solve_kernel`` +
                ``_permute_rhs`` + ``_solve_body``)
factor_solve    ``pallas_linalg.factor_solve`` (``_factor_solve_kernel``)
==============  ====================================================

Shapes carry an explicit lane dimension: ``A`` is ``[L, n, n]``, a
right-hand side ``[L, n]`` or ``[L, n, k]``, ``perm`` ``[L, n]`` int32.
The element type is float64 or float32 (the Pallas kernels take any
float type; the port's f32-polish precision tier runs its bulk march in
float32), and a right-hand side must have the matrix's. Every wrapper
checks device, dtype, shape and contiguity, then sends a CPU tensor to
the plain version (``*_ref``, the same arithmetic in plain PyTorch, in
the tensor's type) and a CUDA tensor to the kernel (``pk_*`` in float64,
``pk_*_f32`` in float32: one templated source). A CUDA tensor is
never served by the plain version: a kernel that cannot be built, loaded
or launched raises :class:`KernelError`. Each launch adds one to
:data:`LAUNCHES` (float64) or :data:`LAUNCHES_F32` (float32), and to
:data:`LAUNCHES_BY_SHAPE` under its size and lane count.

The kernels serve every n (``csrc/linalg.cu``). At n = 16 and 32 all
three take the warp tier: a half-warp or warp per lane with rows in
registers, the substitutions by shuffles. Off it, ``lu_factor`` and
``factor_solve`` take the resident tier while two lanes fit an SM's
shared memory (n <= 119 at k = 1 on an H100 in float64, n <= 168 in
float32): one block per lane factors
the matrix in shared memory 32 columns at a time, the trailing updates
in register tiles; beyond that the panel tier, faster there on an H100,
factors it the same way in device memory (in ``LU`` itself, or in a
workspace this module allocates for ``factor_solve``). ``lu_solve`` off
the warp tier is a tiled substitution: each warp owns 32-row tile rows,
the diagonal tiles are solved by shuffles, one block barrier per tile
column. Every tier keeps each entry's updates in the plain version's
order, so LU and perm are the plain version's bit for bit and
``lu_solve(*lu_factor(A), b)`` is ``factor_solve(A, b)`` bit for bit.
Off the warp tier the k right-hand sides stay in shared memory:
``n * k`` elements (plus ``4 n`` bytes for ``factor_solve``) must fit
that limit (k <= 56 at n = 512 in float64 on an H100, 112 in float32); a
larger k is refused, and the wrapper raises.

The kernels are compiled from the package's own source on first use
(``nvcc`` for ``sm_90a`` into ``build/pycatkin_tpu_torch/`` beside the
package, keyed by a hash of the source) and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

#: Float64 kernel launches per wrapper since the last
#: :func:`reset_launches`.
LAUNCHES = {"lu_factor": 0, "lu_solve": 0, "factor_solve": 0}
#: The same for the float32 kernels.
LAUNCHES_F32 = dict(LAUNCHES)
#: Launches by ``(name, n, lanes)`` (float32 names end ``_f32``),
#: counted with the two above.
LAUNCHES_BY_SHAPE: dict = {}

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "linalg.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" \
    / "pycatkin_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIB = None
_LIB_LOCK = threading.Lock()

#: The C entry points' suffix for each element type the kernels take.
_SUFFIX = {torch.float64: "", torch.float32: "_f32"}


class KernelError(RuntimeError):
    """The kernel library failed to build or load, or a kernel failed to
    launch: a fault of the card or of the program, never of the data."""


def reset_launches() -> None:
    """Set every launch counter to 0."""
    for counter in (LAUNCHES, LAUNCHES_F32):
        for k in counter:
            counter[k] = 0
    LAUNCHES_BY_SHAPE.clear()


def _count(name, dtype, n, lanes) -> None:
    f64 = dtype == torch.float64
    (LAUNCHES if f64 else LAUNCHES_F32)[name] += 1
    key = (name if f64 else name + "_f32", int(n), int(lanes))
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise KernelError("nvcc not found (PATH, $CUDA_HOME/bin): the CUDA "
                      "kernels are built from source on first use")


def library_path() -> Path:
    """Where the built kernel library for the current source lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"linalg_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/linalg.cu`` unless a library built from the same
    source and flags exists; returns its path. ``verbose`` prints the
    compiler's resource usage (``-Xptxas -v``)."""
    so = library_path()
    if so.exists() and not verbose:
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
           "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise KernelError(f"nvcc failed ({proc.returncode}):\n"
                          f"{proc.stdout}\n{proc.stderr}")
    if verbose:
        print(proc.stderr.strip())
    os.replace(tmp, so)
    return so


def _lib():
    """The loaded kernel library, built from source at first use. Each
    process's first call counts one ``pycatkin_compile_total`` (label
    ``kind="build"`` when it ran nvcc, ``"load"`` when a library built
    from the same source was there)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LIB_LOCK:
        if _LIB is not None:
            return _LIB
        built = not library_path().exists()
        try:
            lib = ctypes.CDLL(str(build()))
        except OSError as exc:
            raise KernelError(f"the kernel library does not load: "
                              f"{exc}") from exc
        vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        for sfx in _SUFFIX.values():
            fac = getattr(lib, "pk_lu_factor" + sfx)
            sol = getattr(lib, "pk_lu_solve" + sfx)
            fs = getattr(lib, "pk_factor_solve" + sfx)
            ws = getattr(lib, "pk_factor_solve_workspace" + sfx)
            fac.argtypes = [vp, vp, vp, ll, ci, vp]
            sol.argtypes = [vp, vp, vp, vp, ll, ci, ci, vp]
            fs.argtypes = [vp, vp, vp, vp, ll, ci, ci, vp]
            ws.argtypes = [ci, ci]
            for fn in (fac, sol, fs):
                fn.restype = ci
            ws.restype = ll
        _LIB = lib
        from ..obs import metrics
        metrics.counter("pycatkin_compile_total",
                        "CUDA kernel library builds and loads").inc(
                            kind="build" if built else "load")
    return _LIB


def load():
    """Build (if needed) and load the kernel library now, rather than at
    the first launch."""
    _lib()


def _entry(name, dtype):
    """The C entry point ``name`` for elements of ``dtype``."""
    return getattr(_lib(), name + _SUFFIX[dtype])


# ----------------------------------------------------------------------
# argument checks
def _check_matrix(name, A):
    if A.dtype not in _SUFFIX:
        raise TypeError(f"{name}: float64 or float32 only, got {A.dtype}")
    if A.dim() != 3 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"{name}: expected [lanes, n, n], got "
                         f"{tuple(A.shape)}")
    if not A.is_contiguous():
        raise ValueError(f"{name}: matrix must be contiguous")


def _check_rhs(name, A, b):
    if b.dtype != A.dtype:
        raise TypeError(f"{name}: right-hand side of type {b.dtype} for a "
                        f"{A.dtype} matrix")
    if b.device != A.device:
        raise ValueError(f"{name}: operands on {A.device} and {b.device}")
    ok = (b.dim() in (2, 3) and b.shape[0] == A.shape[0]
          and b.shape[1] == A.shape[-1])
    if not ok:
        raise ValueError(f"{name}: right-hand side must be [lanes, n] or "
                         f"[lanes, n, k], got {tuple(b.shape)} for "
                         f"{tuple(A.shape)}")
    if not b.is_contiguous():
        raise ValueError(f"{name}: right-hand side must be contiguous")


def _route(name, A) -> bool:
    """True for the kernel (CUDA tensor), False for the plain version
    (CPU tensor); raises for anything else."""
    if A.device.type == "cpu":
        return False
    if A.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {A.device}")
    return True


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _raise_on(name, err):
    if err != 0:
        raise KernelError(f"{name}: CUDA kernel launch failed with "
                          f"cudaError {err}")


# ----------------------------------------------------------------------
# plain PyTorch versions
def lu_factor_ref(A):
    """Partial-pivoted LU of every lane, in plain PyTorch: the arithmetic
    of ``linalg._lu_step`` / the Pallas ``_factor_body`` (first row of
    max |a| at or below the diagonal as pivot, multipliers stored below
    the diagonal). Returns ``(LU [L, n, n], perm [L, n] int32)``."""
    A = A.clone()
    L, n, _ = A.shape
    lanes = torch.arange(L, device=A.device)
    perm = torch.arange(n, device=A.device).repeat(L, 1)
    for k in range(n - 1):
        p = k + torch.argmax(torch.abs(A[:, k:, k]), dim=1)
        rk, rp = A[lanes, k].clone(), A[lanes, p].clone()
        A[lanes, k] = rp
        A[lanes, p] = rk
        pk, pp = perm[lanes, k].clone(), perm[lanes, p].clone()
        perm[lanes, k] = pp
        perm[lanes, p] = pk
        f = A[:, k + 1:, k] / A[:, k, k, None]
        A[:, k + 1:, k + 1:] -= f[:, :, None] * A[:, k, None, k + 1:]
        A[:, k + 1:, k] = f
    return A, perm.to(torch.int32)


def lu_solve_ref(LU, perm, b):
    """``b[perm]``, then the unit-lower forward and upper backward
    row-dot recurrences of ``linalg.lu_solve`` / ``_solve_body``, in
    plain PyTorch. ``b``: ``[L, n]`` or ``[L, n, k]``."""
    vec = b.dim() == 2
    y = b[:, :, None] if vec else b
    n, k = y.shape[1], y.shape[2]
    idx = perm.to(torch.int64)[:, :, None].expand(-1, -1, k)
    y = torch.gather(y, 1, idx)
    LUk = LU[:, :, :, None]
    for i in range(1, n):
        y[:, i] -= (LUk[:, i, :i] * y[:, :i]).sum(dim=1)
    for i in range(n - 1, -1, -1):
        if i < n - 1:
            y[:, i] -= (LUk[:, i, i + 1:] * y[:, i + 1:]).sum(dim=1)
        y[:, i] /= LUk[:, i, i]
    return y[:, :, 0] if vec else y


def factor_solve_ref(A, b):
    """Factor and solve in plain PyTorch (:func:`lu_factor_ref` then
    :func:`lu_solve_ref`)."""
    return lu_solve_ref(*lu_factor_ref(A), b)


# ----------------------------------------------------------------------
# wrappers
def lu_factor(A):
    """Partial-pivoted LU of every lane of ``A [L, n, n]`` (float64 or
    float32). Returns ``(LU, perm)`` in ``pallas_linalg.lu_factor``'s
    convention; ``perm`` is int32."""
    _check_matrix("lu_factor", A)
    if not _route("lu_factor", A):
        return lu_factor_ref(A)
    L, n = A.shape[0], A.shape[-1]
    LU = torch.empty_like(A)
    perm = torch.empty((L, n), dtype=torch.int32, device=A.device)
    if L == 0:
        return LU, perm
    fn = _entry("pk_lu_factor", A.dtype)
    with torch.cuda.device(A.device):
        err = fn(A.data_ptr(), LU.data_ptr(), perm.data_ptr(), L, n,
                 _stream(A))
    _raise_on("lu_factor", err)
    _count("lu_factor", A.dtype, n, L)
    return LU, perm


def lu_solve(LU, perm, b):
    """Solve every lane given :func:`lu_factor` output; ``b`` is
    ``[L, n]`` or ``[L, n, k]`` and ``x`` comes back in the same shape."""
    _check_matrix("lu_solve", LU)
    _check_rhs("lu_solve", LU, b)
    if perm.dtype != torch.int32 or perm.shape != LU.shape[:2] \
            or perm.device != LU.device or not perm.is_contiguous():
        raise ValueError("lu_solve: perm must be a contiguous int32 "
                         "[lanes, n] tensor on the matrix's device")
    if not _route("lu_solve", LU):
        return lu_solve_ref(LU, perm, b)
    L, n = LU.shape[0], LU.shape[-1]
    k = 1 if b.dim() == 2 else b.shape[2]
    x = torch.empty_like(b)
    if L == 0:
        return x
    fn = _entry("pk_lu_solve", LU.dtype)
    with torch.cuda.device(LU.device):
        err = fn(LU.data_ptr(), perm.data_ptr(), b.data_ptr(), x.data_ptr(),
                 L, n, k, _stream(LU))
    _raise_on("lu_solve", err)
    _count("lu_solve", LU.dtype, n, L)
    return x


def factor_solve(A, b):
    """Factor and solve ``A x = b`` for every lane in one kernel; the
    factors stay on the chip (registers or shared memory) between the two
    passes wherever the lane fits. ``b`` is ``[L, n]`` or ``[L, n, k]``."""
    _check_matrix("factor_solve", A)
    _check_rhs("factor_solve", A, b)
    if not _route("factor_solve", A):
        return factor_solve_ref(A, b)
    L, n = A.shape[0], A.shape[-1]
    k = 1 if b.dim() == 2 else b.shape[2]
    x = torch.empty_like(b)
    if L == 0:
        return x
    with torch.cuda.device(A.device):
        per_lane = _entry("pk_factor_solve_workspace", A.dtype)(n, k)
        work = torch.empty(L * per_lane, dtype=A.dtype, device=A.device) \
            if per_lane else None
        err = _entry("pk_factor_solve", A.dtype)(
            A.data_ptr(), b.data_ptr(), x.data_ptr(),
            None if work is None else work.data_ptr(), L, n, k, _stream(A))
    _raise_on("factor_solve", err)
    _count("factor_solve", A.dtype, n, L)
    return x
