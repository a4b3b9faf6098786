"""The boundary between the resident and panel tiers of ``lu_factor``,
measured on one CUDA card, in float64 and in float32.

    python3 -m pycatkin_tpu_torch.tools.tier_boundary

Off the warp tier, ``lu_factor`` takes the resident tier (the lane's
matrix in shared memory) while two lanes fit an SM, counted in the
lane's own type's bytes, and the panel tier (the matrix in device
memory) above. The shipped kernels offer no choice of tier, so this
script builds scratch copies of ``csrc/linalg.cu`` into ``build/``: one
that keeps every lane that fits shared memory on the resident tier, one
that sends every n to the panel tier, and one that sizes every lane by
float64 bytes (a float32 lane then takes the tier a float64 lane of its
n takes). At each shape it checks that every copy gives the
shipped library's LU and perm bit for bit, then times them all (CUDA
events). Prints the card's name and power limit and one line a shape and
type; exits 1 without a CUDA card.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from pycatkin_tpu_torch.ops import cuda_linalg as cl

SHAPES = {torch.float64: ((64, 4096), (112, 4096), (128, 4096), (165, 2048)),
          torch.float32: ((64, 4096), (112, 4096), (128, 4096), (165, 2048),
                          (200, 2048), (256, 2048))}
REPS = 20

# Text changes of the source per variant; each must match once.
VARIANTS = {
    "resident": (("  return lanes == 2 ? 256 : 0;",
                  "  return lanes >= 1 ? 256 : 0;"),),
    "panel": (("  const int threads = factor_threads<T>(n, limit);",
               "  const int threads = 0;"),),
    "f64_bytes": (("resident_smem<T>(n, 0), limit);",
                   "resident_smem<double>(n, 0), limit);"),),
}


def build_variants() -> dict:
    """Compiles each variant (in parallel) and the shipped library;
    returns the loaded libraries by name."""
    src = cl.SOURCE.read_text()
    cl.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, changes in VARIANTS.items():
        text = src
        for old, new in changes:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the text it replaces is not in "
                                   f"{cl.SOURCE} exactly once: {old!r}")
            text = text.replace(old, new)
        cu = cl.BUILD_DIR / f"tier_{name}.cu"
        cu.write_text(text)
        so = cl.BUILD_DIR / f"tier_{name}.so"
        procs[name] = (so, subprocess.Popen(
            [cl._nvcc(), *cl.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {"shipped": ctypes.CDLL(str(cl.build()))}
    for name, (so, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc ({name}) failed:\n{out}\n{err}")
        libs[name] = ctypes.CDLL(str(so))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for lib in libs.values():
        for fn in (lib.pk_lu_factor, lib.pk_lu_factor_f32):
            fn.argtypes = [vp, vp, vp, ll, ci, vp]
            fn.restype = ci
    return libs


def factor(lib, A):
    L, n = A.shape[0], A.shape[-1]
    LU = torch.empty_like(A)
    perm = torch.empty((L, n), dtype=torch.int32, device=A.device)
    fn = lib.pk_lu_factor if A.dtype == torch.float64 else lib.pk_lu_factor_f32
    err = fn(A.data_ptr(), LU.data_ptr(), perm.data_ptr(), L, n,
             cl._stream(A))
    if err != 0:
        raise RuntimeError(f"lu_factor n={n} {A.dtype}: cudaError {err}")
    return LU, perm


def ms(lib, A) -> float:
    for _ in range(2):
        factor(lib, A)
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(REPS):
        factor(lib, A)
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / REPS


def main() -> int:
    if not torch.cuda.is_available():
        print("tier_boundary: no CUDA device available", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    libs = build_variants()
    for dtype, shapes in SHAPES.items():
        for n, L in shapes:
            rng = np.random.default_rng(n)
            A = torch.tensor(rng.standard_normal((L, n, n))
                             + 2.0 * n * np.eye(n), device="cuda").to(dtype)
            LU, perm = factor(libs["shipped"], A)
            for name in VARIANTS:
                LUv, permv = factor(libs[name], A)
                if not (torch.equal(LU, LUv) and torch.equal(perm, permv)):
                    raise RuntimeError(f"n={n} {dtype}: the {name} copy's LU "
                                       f"or perm differs from the shipped "
                                       f"library's")
            times = {name: ms(lib, A) for name, lib in libs.items()}
            print(f"lu_factor {str(dtype)[6:]} n={n} x {L} lanes | "
                  + " ".join(f"{k} {v:.4f} ms" for k, v in times.items()),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
