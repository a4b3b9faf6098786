"""The CUDA kernels' own source, run on the CPU.

``pycatkin_tpu_torch/csrc/linalg.cu`` is compiled here with the host C++
compiler against a small emulation of the CUDA features it uses: each
thread block runs as ``blockDim.x`` real threads with real barriers
(``__syncthreads``), warp shuffles go through a shared slot array, and
launches run the blocks one after another. That exercises the kernels'
indexing, pivot reduction and barrier placement without a card; the
results are held against the plain PyTorch versions with the same
contract as on the card (perm equal, LU bit for bit, x within 1e-12
relative, a singular lane non-finite). Skips when no C++20 compiler is
installed."""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from pycatkin_tpu_torch.ops import cuda_linalg as cl

EMULATION_HEADER = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstddef>
#include <functional>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
struct dim3v { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3v threadIdx;
inline dim3v blockIdx, blockDim;
inline std::barrier<>* g_block = nullptr;
inline std::barrier<>* g_warp = nullptr;
inline double g_slot_d[32];
inline int g_slot_i[32];
inline double g_smem[1 << 15];
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline void __syncthreads() { g_block->arrive_and_wait(); }
template <class T> T shfl(T* slot, T v, int off) {
  const int l = threadIdx.x;
  slot[l] = v;
  g_warp->arrive_and_wait();
  T r = (l + off < 32) ? slot[l + off] : v;
  g_warp->arrive_and_wait();
  return r;
}
inline double __shfl_down_sync(unsigned, double v, int off) {
  return shfl(g_slot_d, v, off);
}
inline int __shfl_down_sync(unsigned, int v, int off) {
  return shfl(g_slot_i, v, off);
}
template <class K> cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute,
                                                    int) { return 0; }
inline cudaError_t cudaGetLastError() { return 0; }
inline void emu_launch(long long grid, int nt, std::function<void()> body) {
  std::barrier<> block(nt), warp(32);
  g_block = &block;
  g_warp = &warp;
  blockDim.x = nt;
  for (long long b = 0; b < grid; ++b) {
    blockIdx.x = static_cast<unsigned>(b);
    std::vector<std::thread> ts;
    for (int t = 0; t < nt; ++t)
      ts.emplace_back([&, t] { threadIdx.x = t; body(); });
    for (auto& th : ts) th.join();
  }
}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to run the kernel emulation")
    d = tmp_path_factory.mktemp("kernel_emulation")
    (d / "cuda_runtime.h").write_text(EMULATION_HEADER)
    src = cl.SOURCE.read_text()
    src = re.sub(r"(\w+)<<<(.*?),(.*?),(.*?),(.*?)>>>\((.*?)\);",
                 lambda m: (f"emu_launch({m.group(2)}, {m.group(3)}, "
                            f"[&] {{ {m.group(1)}({m.group(6)}); }});"),
                 src, flags=re.S)
    src = src.replace("extern __shared__ double smem[];",
                      "double* smem = g_smem;")
    (d / "linalg_emu.cpp").write_text(src)
    so = d / "libemu.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", f"-I{d}", "-o",
         str(so), str(d / "linalg_emu.cpp"), "-lpthread"],
        capture_output=True, text=True, timeout=300)
    if proc.returncode != 0 and "barrier" in proc.stderr:
        pytest.skip("host C++ compiler lacks std::barrier (C++20)")
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.pk_lu_factor.argtypes = [vp, vp, vp, ll, ci, vp]
    lib.pk_lu_solve.argtypes = [vp, vp, vp, vp, ll, ci, ci, vp]
    lib.pk_factor_solve.argtypes = [vp, vp, vp, ll, ci, ci, vp]
    assert lib.pk_max_n() == cl.MAX_N
    return lib


@pytest.mark.parametrize("n,k", [(1, None), (5, None), (5, 3), (21, None),
                                 (21, 3), (33, None)])
def test_kernel_source_matches_plain_versions(emulated, n, k):
    lib = emulated
    rng = np.random.default_rng(n)
    L = 3
    A = rng.standard_normal((L, n, n)) + 2.0 * n * np.eye(n)
    A[1] = A[1][rng.permutation(n)]
    if n > 1:
        A[2, :, n // 2] = 0.0                   # singular lane
    At = torch.tensor(A)
    bt = torch.tensor(rng.standard_normal((L, n) if k is None
                                          else (L, n, k)))
    nrhs = 1 if k is None else k
    LU = torch.empty_like(At)
    perm = torch.empty((L, n), dtype=torch.int32)
    x = torch.empty_like(bt)
    xf = torch.empty_like(bt)
    assert lib.pk_lu_factor(At.data_ptr(), LU.data_ptr(), perm.data_ptr(),
                            L, n, None) == 0
    assert lib.pk_lu_solve(LU.data_ptr(), perm.data_ptr(), bt.data_ptr(),
                           x.data_ptr(), L, n, nrhs, None) == 0
    assert lib.pk_factor_solve(At.data_ptr(), bt.data_ptr(), xf.data_ptr(),
                               L, n, nrhs, None) == 0
    LUr, permr = cl.lu_factor_ref(At)
    xr = cl.lu_solve_ref(LUr, permr, bt)
    good = slice(0, 2) if n > 1 else slice(0, 3)
    assert torch.equal(perm[good], permr[good])
    assert torch.equal(LU[good], LUr[good])
    scale = float(xr[good].abs().max())
    assert float((x[good] - xr[good]).abs().max()) <= 1e-12 * scale
    assert torch.equal(xf[good], x[good])
    if n > 1:
        assert not bool(torch.isfinite(x[2]).all())
        assert not bool(torch.isfinite(xf[2]).all())


def test_kernel_entry_points_reject_bad_sizes(emulated):
    lib = emulated
    assert lib.pk_lu_factor(None, None, None, 1, cl.MAX_N + 1, None) != 0
    assert lib.pk_lu_solve(None, None, None, None, 1, 4, 0, None) != 0
    assert lib.pk_factor_solve(None, None, None, 0, 4, 1, None) != 0
