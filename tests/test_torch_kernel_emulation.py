"""The CUDA kernels' own source, run on the CPU.

``pycatkin_tpu_torch/csrc/linalg.cu`` is compiled here with the host C++
compiler against a small emulation of the CUDA features it uses. Each
thread block runs as ``blockDim.x`` fibers on one host thread, each
fiber running until it waits at a barrier: ``__syncthreads`` for the
block, and per warp one barrier for the whole warp and one for each
half-warp (the masks ``__syncwarp`` and the collectives are given).
Shuffles, ballots and reductions (with a ``width`` where CUDA has one)
go through per-warp slot arrays; a thread that returns drops out of its
barriers, and a block in which every thread waits aborts. Launches run
the blocks one after another. That exercises the kernels' indexing,
pivot search and barrier placement without a card -- blocks of several
warps, half-warp lanes, a partial last block, the resident tier, the
tiled lu_solve and the panel tier (at small n, under a lowered opt-in
limit or SM count) -- and the results are held against the plain
PyTorch versions with the same contract as on the card (perm equal, LU
bit for bit, x within 1e-12 relative, lu_solve after lu_factor equal to
factor_solve, a singular lane non-finite and its neighbours untouched),
for both instantiations of the source: every case runs in float64 and
in float32 (id ``-float32``, x within 1e-12 times eps32 / eps64).
Skips when no host C++ compiler is installed."""

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
#include <ucontext.h>
#include <algorithm>
#include <cmath>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <cstdint>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __restrict__
#define __launch_bounds__(...)
using std::fabs;
using std::max;
using std::min;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaErrorInvalidDevice = 101 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize };
enum cudaDeviceAttr { cudaDevAttrMaxSharedMemoryPerBlockOptin,
                      cudaDevAttrMultiProcessorCount,
                      cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                      cudaDevAttrReservedSharedMemoryPerBlock };
struct dim3v { unsigned x = 0, y = 0, z = 0; };
struct double2 { double x, y; };
inline double2 make_double2(double x, double y) { return {x, y}; }
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
// Every CUDA thread of a block is a fiber; the fibers of one block take
// turns on one host thread, each running until it waits at a barrier.
// On x86-64 a switch saves the callee-saved registers and swaps stacks
// (glibc's swapcontext also makes a system call for the signal mask).
struct Fiber {
  ucontext_t ctx;
  void* sp = nullptr;
  dim3v tid;
  bool done = false;
};
inline Fiber* g_cur = nullptr;
inline ucontext_t g_scheduler;
inline void* g_scheduler_sp = nullptr;
inline long long g_progress = 0;
#define threadIdx (g_cur->tid)
inline dim3v blockIdx, blockDim;
#if defined(__x86_64__)
extern "C" void emu_switch(void** save_sp, void* load_sp);
asm(R"(
  .text
  .p2align 4
  .hidden emu_switch
  .globl emu_switch
  .type emu_switch, @function
emu_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size emu_switch, .-emu_switch
)");
inline void yield_fiber() { emu_switch(&g_cur->sp, g_scheduler_sp); }
inline void run_fiber(Fiber& f) { emu_switch(&g_scheduler_sp, f.sp); }
#else
inline void yield_fiber() { swapcontext(&g_cur->ctx, &g_scheduler); }
inline void run_fiber(Fiber& f) { swapcontext(&g_scheduler, &f.ctx); }
#endif
struct Barrier {
  int expected, count = 0;
  unsigned generation = 0;
  explicit Barrier(int n) : expected(n) {}
  void release() { count = 0; ++generation; ++g_progress; }
  void arrive_and_wait() {
    const unsigned mine = generation;
    ++g_progress;
    if (++count == expected) return release();
    while (generation == mine) yield_fiber();
  }
  void drop() {  // a thread that returned no longer takes part
    --expected;
    if (count > 0 && count == expected) release();
  }
};
// One barrier for the block, and per warp one for the whole warp and one
// for each half (the masks __syncwarp and the shuffles are given); a
// thread that returns drops out of all of them, as on the card.
struct Warp {
  Barrier full{32}, half0{16}, half1{16};
  double slot_d[32];
  float slot_f[32];
  int slot_i[32];
  unsigned slot_u[32];
};
inline Barrier* g_block = nullptr;
inline std::vector<std::unique_ptr<Warp>> g_warps;
inline double g_smem[232448 / 8];
// The opt-in limit the kernels read (the H100's unless a test lowers it,
// so that the tiers switch at smaller n).
inline int g_optin = static_cast<int>(sizeof(g_smem));
extern "C" void emu_set_optin(int bytes) { g_optin = bytes; }
// The SM count the kernels read (the H100's unless a test lowers it).
inline int g_sms = 132;
extern "C" void emu_set_sms(int sms) { g_sms = sms; }
inline Warp& my_warp() { return *g_warps[threadIdx.x / 32]; }
inline Barrier& group_barrier(unsigned mask) {
  Warp& w = my_warp();
  if (mask == 0xffffffffu) return w.full;
  if (mask == 0x0000ffffu) return w.half0;
  if (mask == 0xffff0000u) return w.half1;
  std::abort();
}
inline double __dsub_rn(double a, double b) { return a - b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline void __syncwarp(unsigned mask = 0xffffffffu) {
  group_barrier(mask).arrive_and_wait();
}
inline int __ffs(int v) { return __builtin_ffs(v); }
// Fibers take turns, so a read-modify-write is atomic as it stands.
inline int atomicAdd(int* p, int v) {
  const int old = *p;
  *p = old + v;
  return old;
}
// Lane l of the warp reads the value lane src(l) put in the slot.
template <class T, class F> T exchange(unsigned mask, T* slot, T v, F src) {
  const int l = threadIdx.x % 32;
  auto& bar = group_barrier(mask);
  slot[l] = v;
  bar.arrive_and_wait();
  T r = slot[src(l)];
  bar.arrive_and_wait();
  return r;
}
template <class T> T* slots(Warp& w);
template <> inline double* slots<double>(Warp& w) { return w.slot_d; }
template <> inline float* slots<float>(Warp& w) { return w.slot_f; }
template <> inline int* slots<int>(Warp& w) { return w.slot_i; }
template <class T> T __shfl_down_sync(unsigned mask, T v, int off) {
  return exchange(mask, slots<T>(my_warp()), v,
                  [&](int l) { return l + off < 32 ? l + off : l; });
}
template <class T> T __shfl_xor_sync(unsigned mask, T v, int off, int w) {
  return exchange(mask, slots<T>(my_warp()), v,
                  [&](int l) { return l ^ (off & (w - 1)); });
}
template <class T> T __shfl_sync(unsigned mask, T v, int src, int w = 32) {
  return exchange(mask, slots<T>(my_warp()), v,
                  [&](int l) { return (l & ~(w - 1)) | (src & (w - 1)); });
}
template <class T> T __reduce_max_sync(unsigned mask, T v) {
  Warp& w = my_warp();
  T* slot = reinterpret_cast<T*>(w.slot_u);
  const int l = threadIdx.x % 32;
  auto& bar = group_barrier(mask);
  slot[l] = v;
  bar.arrive_and_wait();
  T m = v;
  for (int i = 0; i < 32; ++i)
    if (((mask >> i) & 1u) && slot[i] > m) m = slot[i];
  bar.arrive_and_wait();
  return m;
}
template <class T> T __reduce_min_sync(unsigned mask, T v) {
  return -__reduce_max_sync(mask, -v);
}
inline int __double2hiint(double d) {
  long long b;
  std::memcpy(&b, &d, 8);
  return static_cast<int>(b >> 32);
}
inline int __double2loint(double d) {
  long long b;
  std::memcpy(&b, &d, 8);
  return static_cast<int>(b & 0xffffffffLL);
}
inline int __float_as_int(float f) {
  int b;
  std::memcpy(&b, &f, 4);
  return b;
}
inline unsigned __ballot_sync(unsigned mask, bool pred);
inline bool __any_sync(unsigned mask, bool pred) {
  return __ballot_sync(mask, pred) != 0;
}
inline unsigned __ballot_sync(unsigned mask, bool pred) {
  Warp& w = my_warp();
  const int l = threadIdx.x % 32;
  auto& bar = group_barrier(mask);
  w.slot_u[l] = pred ? 1u : 0u;
  bar.arrive_and_wait();
  unsigned bits = 0;
  for (int i = 0; i < 32; ++i)
    if ((mask >> i) & 1u) bits |= w.slot_u[i] << i;
  bar.arrive_and_wait();
  return bits;
}
template <class K> cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute,
                                                    int bytes) {
  return bytes <= g_optin ? 0 : cudaErrorInvalidValue;
}
struct cudaFuncAttributes { size_t sharedSizeBytes; };
template <class K> cudaError_t cudaFuncGetAttributes(cudaFuncAttributes* a,
                                                     K) {
  a->sharedSizeBytes = 0;
  return 0;
}
// One block an SM at every size: the panel tier then takes its widest
// shape that fits.
template <class K> cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
    int* blocks, K, int, size_t) {
  *blocks = 1;
  return 0;
}
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
// Per SM, the block opt-in limit plus the 1 KB each block reserves.
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr a, int) {
  switch (a) {
    case cudaDevAttrMaxSharedMemoryPerBlockOptin: *v = g_optin; break;
    case cudaDevAttrMultiProcessorCount: *v = g_sms; break;
    case cudaDevAttrMaxSharedMemoryPerMultiprocessor: *v = g_optin + 1024;
      break;
    case cudaDevAttrReservedSharedMemoryPerBlock: *v = 1024; break;
  }
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
// Runs the blocks one after another, each with fresh barriers; aborts
// if every thread of a block waits and none can go on.
inline std::function<void()>* g_body = nullptr;
inline void fiber_main() {
  (*g_body)();
  g_cur->done = true;
  Warp& w = my_warp();
  g_block->drop();
  w.full.drop();
  (g_cur->tid.x % 32 < 16 ? w.half0 : w.half1).drop();
  yield_fiber();
}
inline void emu_launch(long long grid, int nt, std::function<void()> body) {
  constexpr size_t kStack = 64 * 1024;
  std::vector<char> stacks(kStack * nt);
  g_body = &body;
  blockDim.x = nt;
  for (long long b = 0; b < grid; ++b) {
    Barrier block(nt);
    g_block = &block;
    g_warps.clear();
    for (int w = 0; w < nt / 32; ++w)
      g_warps.push_back(std::make_unique<Warp>());
    blockIdx.x = static_cast<unsigned>(b);
    std::vector<Fiber> fibers(nt);
    for (int t = 0; t < nt; ++t) {
      Fiber& f = fibers[t];
      f.tid.x = t;
#if defined(__x86_64__)
      // A fresh stack emu_switch can "return" into fiber_main from: six
      // register slots, then fiber_main's address, 16-byte aligned as a
      // call would leave it.
      auto top = reinterpret_cast<std::uintptr_t>(stacks.data() +
                                                  kStack * (t + 1));
      auto* sp = reinterpret_cast<void**>((top & ~std::uintptr_t{15}) - 8);
      *--sp = reinterpret_cast<void*>(&fiber_main);
      for (int i = 0; i < 6; ++i) *--sp = nullptr;
      f.sp = sp;
#else
      getcontext(&f.ctx);
      f.ctx.uc_stack.ss_sp = stacks.data() + kStack * t;
      f.ctx.uc_stack.ss_size = kStack;
      f.ctx.uc_link = nullptr;
      makecontext(&f.ctx, fiber_main, 0);
#endif
    }
    for (int alive = nt; alive > 0;) {
      const long long before = g_progress;
      alive = 0;
      for (Fiber& f : fibers) {
        if (f.done) continue;
        g_cur = &f;
        run_fiber(f);
        if (!f.done) ++alive;
      }
      if (alive > 0 && g_progress == before) {
        std::fprintf(stderr, "emulation: every thread waits (deadlock)\n");
        std::abort();
      }
    }
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
    src = re.sub(r"(\w+(?:<[\w, ]+>)?)<<<(.*?),(.*?),(.*?),(.*?)>>>\((.*?)\);",
                 lambda m: (f"emu_launch({m.group(2)}, {m.group(3)}, "
                            f"[&] {{ {m.group(1)}({m.group(6)}); }});"),
                 src, flags=re.S)
    src = src.replace(
        "extern __shared__ __align__(16) unsigned char smem_bytes[];",
        "unsigned char* smem_bytes = reinterpret_cast<unsigned char*>"
        "(g_smem);")
    (d / "linalg_emu.cpp").write_text(src)
    so = d / "libemu.so"
    proc = subprocess.run(
        [cxx, "-std=c++20", "-O1", "-shared", "-fPIC", f"-I{d}", "-o",
         str(so), str(d / "linalg_emu.cpp"), "-lpthread"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    vp, ll, ci = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    for sfx in ("", "_f32"):
        getattr(lib, "pk_lu_factor" + sfx).argtypes = [vp, vp, vp, ll, ci, vp]
        getattr(lib, "pk_lu_solve" + sfx).argtypes = [vp, vp, vp, vp, ll, ci,
                                                      ci, vp]
        getattr(lib, "pk_factor_solve" + sfx).argtypes = [vp, vp, vp, vp, ll,
                                                          ci, ci, vp]
        ws = getattr(lib, "pk_factor_solve_workspace" + sfx)
        ws.argtypes = [ci, ci]
        ws.restype = ll
    return lib


def _typed(cases, ids):
    """Each case once per element type of the kernels: the float64 case
    keeps its id, the float32 one (the source's float instantiation)
    adds ``-float32``."""
    out = []
    for case, i in zip(cases, ids):
        case = case if isinstance(case, tuple) else (case,)
        out.append(pytest.param(*case, torch.float64, id=i))
        out.append(pytest.param(*case, torch.float32, id=f"{i}-float32"))
    return out


def _entry(lib, name, dtype):
    """The C entry point ``name`` for the element type ``dtype``."""
    return getattr(lib, name + ("_f32" if dtype == torch.float32 else ""))


def _low_bits(n, dtype):
    """2n times (1 + the smallest relative step that still changes the
    type's value in its low bits: 2^-40 of a double, 2^-20 of a
    float)."""
    return 2.0 * n * (1.0 + (2.0 ** -40 if dtype == torch.float64
                             else 2.0 ** -20))


GUARD = 3   # lanes past the end of every output, which no kernel may touch


def _run_kernels(lib, At, bt):
    """All three kernels on every lane: (LU, perm, x, x of factor_solve).
    Each output has GUARD more lanes than the launch is given, filled
    with a sentinel that must survive."""
    L, n = At.shape[0], At.shape[-1]
    nrhs = 1 if bt.dim() == 2 else bt.shape[2]
    outs = [torch.full((L + GUARD,) + tuple(t.shape[1:]), -7.0,
                       dtype=t.dtype) for t in (At, bt, bt)]
    perm = torch.full((L + GUARD, n), -7, dtype=torch.int32)
    LU, x, xf = outs
    per_lane = _entry(lib, "pk_factor_solve_workspace", At.dtype)(n, nrhs)
    work = torch.empty(L * per_lane, dtype=At.dtype)
    assert _entry(lib, "pk_lu_factor", At.dtype)(
        At.data_ptr(), LU.data_ptr(), perm.data_ptr(), L, n, None) == 0
    assert _entry(lib, "pk_lu_solve", At.dtype)(
        LU.data_ptr(), perm.data_ptr(), bt.data_ptr(), x.data_ptr(), L, n,
        nrhs, None) == 0
    assert _entry(lib, "pk_factor_solve", At.dtype)(
        At.data_ptr(), bt.data_ptr(), xf.data_ptr(),
        work.data_ptr() if per_lane else None, L, n, nrhs, None) == 0
    for t in (LU, perm, x, xf):
        assert bool((t[L:] == -7).all()), "a kernel wrote past its lanes"
    return LU[:L], perm[:L], x[:L], xf[:L]


def _hold_to_contract(At, bt, out, good, bad=()):
    """perm equal, LU bit for bit, x within 1e-12 relative on the lanes
    ``good`` (in float32 1e-12 times the ratio of the two epsilons,
    ~5.4e-4); factor_solve's x is lu_solve's bit for bit; the lanes
    ``bad`` come out non-finite."""
    LU, perm, x, xf = out
    LUr, permr = cl.lu_factor_ref(At)
    xr = cl.lu_solve_ref(LUr, permr, bt)
    assert torch.equal(perm[good], permr[good])
    assert torch.equal(LU[good], LUr[good])
    scale = float(xr[good].abs().max())
    tol = 1e-12 * torch.finfo(At.dtype).eps / torch.finfo(torch.float64).eps
    assert float((x[good] - xr[good]).abs().max()) <= tol * scale
    assert torch.equal(xf[good], x[good])
    for i in bad:
        assert not bool(torch.isfinite(x[i]).all())
        assert not bool(torch.isfinite(xf[i]).all())


SOURCE_CASES = [(1, None), (5, None), (5, 3), (21, None), (21, 3),
                (33, None), (9, 4), (33, 4), (70, 4), (100, 2), (119, 2)]


@pytest.mark.parametrize("n,k,dtype", _typed(
    SOURCE_CASES, [f"{n}-{k}" for n, k in SOURCE_CASES]))
def test_kernel_source_matches_plain_versions(emulated, n, k, dtype):
    """Off the warp tier: the resident factorization (one panel at n <= 32,
    full and partial last panels above) and the tiled lu_solve (one tile
    row, and two and three of them with partial last tiles). At n = 119
    lu_factor takes the resident tier's last n (two lanes an SM, 256
    threads) while factor_solve, whose two right-hand sides leave room
    for one lane, takes the panel tier: the tiers still agree bit for
    bit."""
    rng = np.random.default_rng(n)
    L = 3
    A = rng.standard_normal((L, n, n)) + 2.0 * n * np.eye(n)
    A[1] = A[1][rng.permutation(n)]
    if n > 1:
        A[2, :, n // 2] = 0.0                   # singular lane
    At = torch.tensor(A, dtype=dtype)
    bt = torch.tensor(rng.standard_normal((L, n) if k is None
                                          else (L, n, k)), dtype=dtype)
    if n == 119:   # factor_solve takes the panel tier there in float64
        assert _entry(emulated, "pk_factor_solve_workspace", dtype)(
            n, k) == (n * n if dtype == torch.float64 else 0)
    out = _run_kernels(emulated, At, bt)
    if n > 1:
        _hold_to_contract(At, bt, out, slice(0, 2), bad=(2,))
    else:
        _hold_to_contract(At, bt, out, slice(0, 3))


def _tie_matrix(rng, n):
    """A well-conditioned matrix of small integers: many equal entries in
    each column, so the first-maximum pivot rule decides."""
    while True:
        M = rng.integers(-2, 3, (n, n)).astype(np.float64)
        if np.linalg.cond(M) < 1e6:
            return M


WARP_CASES = [(16, None), (32, None), (16, 2), (32, 3)]


@pytest.mark.parametrize("n,k,dtype", _typed(
    WARP_CASES, [f"{n}-{k}" for n, k in WARP_CASES]))
def test_warp_tier_isolates_lanes_of_a_block(emulated, n, k, dtype):
    """The warp tier (n = 16 or 32, 8 or 4 lanes a block): 11 lanes leave a
    partial last block; lane 5, in the middle of the second block of 4
    (or the first of 8), is singular and lane 6 all NaN; lanes 2 and 9
    have tied column maxima, and lane 3 a first column whose two largest
    entries differ only in their low bits (the low word of a double), the
    larger one further down. Every other lane matches the plain version exactly as the
    contract says."""
    rng = np.random.default_rng(100 + n)
    L = 11
    A = rng.standard_normal((L, n, n)) + 2.0 * n * np.eye(n)
    for i in (1, 4, 8, 10):
        A[i] = A[i][rng.permutation(n)]
    A[2], A[9] = _tie_matrix(rng, n), _tie_matrix(rng, n)
    A[3, :, 0] *= 0.01
    A[3, 0, 0], A[3, n - 2, 0] = 2.0 * n, _low_bits(n, dtype)
    A[5, :, n // 2] = 0.0
    A[6] = np.nan
    At = torch.tensor(A, dtype=dtype)
    bt = torch.tensor(rng.standard_normal((L, n) if k is None
                                          else (L, n, k)), dtype=dtype)
    out = _run_kernels(emulated, At, bt)
    good = [i for i in range(L) if i not in (5, 6)]
    _hold_to_contract(At, bt, out, good, bad=(5, 6))
    assert not bool(torch.isfinite(out[0][5]).all())
    # The low-bits tie: the larger entry, further down, is the pivot.
    assert int(out[1][3, 0]) == n - 2


# The largest n at which factor_solve (k = 1) takes the resident tier:
# two lanes an SM, counted in the type's bytes.
RESIDENT_MAX = {torch.float64: 119, torch.float32: 168}


@pytest.mark.parametrize("n,dtype", _typed(
    [64, 170, 100, 119, 120],
    ["shared", "device", "shared-100", "shared-119", "device-120"]))
def test_block_tier_pivots_on_updated_columns(emulated, n, dtype):
    """The block tiers on Gaussian matrices without a dominant diagonal,
    so every pivot search reads columns the previous step updated: at
    n = 64, 100 and 119 in shared memory (the resident tier, with six and
    two lanes an H100 SM), and at n = 120 and 170, where the panel tier
    takes it in float64 (in float32 only at 170): lu_factor works in LU
    and factor_solve in its workspace. The resident tier serves n while
    two lanes fit an SM (at k = 1 n <= 119 in float64, n <= 168 in
    float32: :data:`RESIDENT_MAX`). Lane 1 is singular."""
    L = 2
    workspace = _entry(emulated, "pk_factor_solve_workspace", dtype)
    last = RESIDENT_MAX[dtype]
    assert workspace(last, 1) == 0
    assert workspace(last + 1, 1) == (last + 1) ** 2
    assert workspace(n, 1) == (n * n if n > last else 0)
    rng = np.random.default_rng(n)
    A = rng.standard_normal((L, n, n))
    A[1, :, n // 2] = 0.0
    At = torch.tensor(A, dtype=dtype)
    bt = torch.tensor(rng.standard_normal((L, n)), dtype=dtype)
    lib = emulated
    _hold_to_contract(At, bt, _run_kernels(lib, At, bt), [0], bad=(1,))


H100_OPTIN = 232448


@pytest.fixture
def optin(emulated):
    """Sets the emulated opt-in limit for one test (the tiers switch by
    it), and puts the H100's back afterwards."""
    yield emulated.emu_set_optin
    emulated.emu_set_optin(H100_OPTIN)


# (n, k, opt-in limit in bytes, what the panel tier then runs). The limit
# is one at which the lane no longer fits shared memory, so the panel tier
# takes sizes the emulation runs in seconds.
PANEL_CASES = [
    (64, None, 30000, "b = 32, chunks of 16; n a multiple of b"),
    (70, None, 30000, "b = 32, chunks of 16; a last panel of 6"),
    (70, 3, 30000, "b = 32, chunks of 16; three right-hand sides"),
    (96, None, 70000, "b = 32, chunks of 64; n a multiple of b"),
    (100, 2, 70000, "b = 32, chunks of 64; a last panel of 4"),
    (70, None, 20000, "b = 16, chunks of 32; a last panel of 6"),
    (40, None, 3000, "b = 2, chunks of 32"),
    (40, 8, 3000, "b = 2; eight right-hand sides, which take more shared "
     "memory than the panel's working set"),
]


@pytest.mark.parametrize("n,k,limit,what,dtype", _typed(
    PANEL_CASES, [f"{c[0]}-{c[1]}-{c[2]}" for c in PANEL_CASES]))
def test_panel_tier_matches_plain_versions(emulated, optin, n, k, limit,
                                           what, dtype):
    """The panel tier (the lane's matrix in device memory, factored a
    panel at a time) at an opt-in limit that sends n there. Eight lanes,
    one block each: 0 diagonally dominant, 1 and 7 the same with shuffled
    rows (pivots leave the panel's top rows), 2 tied column maxima (small
    integers), 3 a first column whose two largest entries differ only in
    their low bits, the larger further down, 4 Gaussian (every pivot
    search reads updated columns, across panels), 5 singular, 6 all NaN.
    Every other lane matches the plain version exactly as the contract
    says (perm and LU bit for bit), in lu_factor and factor_solve; the
    lanes past the launch stay untouched."""
    optin(limit)
    lib = emulated
    nrhs = 1 if k is None else k
    assert _entry(lib, "pk_factor_solve_workspace", dtype)(
        n, nrhs) == n * n, what
    rng = np.random.default_rng(1000 + n)
    L = 8
    A = rng.standard_normal((L, n, n)) + 2.0 * n * np.eye(n)
    for i in (1, 7):
        A[i] = A[i][rng.permutation(n)]
    A[2] = _tie_matrix(rng, n)
    A[3, :, 0] *= 0.01
    A[3, 0, 0], A[3, n - 2, 0] = 2.0 * n, _low_bits(n, dtype)
    A[4] = rng.standard_normal((n, n))
    A[5, :, n // 2] = 0.0
    A[6] = np.nan
    At = torch.tensor(A, dtype=dtype)
    bt = torch.tensor(rng.standard_normal((L, n) if k is None
                                          else (L, n, k)), dtype=dtype)
    out = _run_kernels(lib, At, bt)
    good = [i for i in range(L) if i not in (5, 6)]
    _hold_to_contract(At, bt, out, good, bad=(5, 6))
    assert not bool(torch.isfinite(out[0][5]).all())
    assert not bool(torch.isfinite(out[0][6]).all())
    # The low-bits tie: the larger entry, further down, is the pivot.
    assert int(out[1][3, 0]) == n - 2


# (n, k, opt-in limit, SMs, what the tiled lu_solve then runs): the limit
# in elements of the type, (y, tiles of 33 x 32, extra), leaves room
# beside y for fewer tiles than the lane has tile rows, or for none (None:
# the H100's); one SM leaves the three lanes no single wave.
TILE_ELEMS = 33 * 32
SOLVE_CASES = [
    (70, None, (70, 2, 0), 132, "two warps for three tile rows"),
    (70, 4, (280, 1, -1), 132, "no tile beside y: rows read from "
     "device memory"),
    (100, 2, None, 1, "one warp for four tile rows"),
]


def _solve_limit(limit, itemsize):
    if limit is None:
        return H100_OPTIN
    y, tiles, extra = limit
    return itemsize * (y + tiles * TILE_ELEMS + extra)


@pytest.mark.parametrize("n,k,limit,sms,what,dtype", _typed(
    SOLVE_CASES, [f"{c[0]}-{c[1]}-{_solve_limit(c[2], 8)}-{c[3]}"
                  for c in SOLVE_CASES]))
def test_tiled_solve_at_a_lowered_limit(emulated, optin, n, k, limit, sms,
                                        what, dtype):
    """The tiled lu_solve where shared memory holds fewer warps' tiles
    than the lane has tile rows (a warp then owns rows 0 and 2), or none
    (each thread reads its row of a tile from device memory), and where
    the lanes outnumber what one wave holds (one warp a lane). Three
    lanes, the last singular."""
    optin(_solve_limit(limit, torch.finfo(dtype).bits // 8))
    emulated.emu_set_sms(sms)
    try:
        rng = np.random.default_rng(2000 + n)
        A = rng.standard_normal((3, n, n)) + 2.0 * n * np.eye(n)
        A[1] = A[1][rng.permutation(n)]
        A[2, :, n // 2] = 0.0
        At = torch.tensor(A, dtype=dtype)
        bt = torch.tensor(rng.standard_normal((3, n) if k is None
                                              else (3, n, k)), dtype=dtype)
        _hold_to_contract(At, bt, _run_kernels(emulated, At, bt), [0, 1],
                          bad=(2,))
    finally:
        emulated.emu_set_sms(132)


def test_kernel_entry_points_reject_bad_sizes(emulated):
    for dtype in (torch.float64, torch.float32):
        fac, sol, fs = (_entry(emulated, name, dtype) for name in (
            "pk_lu_factor", "pk_lu_solve", "pk_factor_solve"))
        assert fac(None, None, None, 1, 0, None) != 0
        assert sol(None, None, None, None, 1, 4, 0, None) != 0
        assert fs(None, None, None, None, 0, 4, 1, None) != 0
        # A lane too large for shared memory needs its workspace.
        assert fs(None, None, None, None, 1, 200, 1, None) != 0
