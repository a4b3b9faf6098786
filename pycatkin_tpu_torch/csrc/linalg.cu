// Batched dense LU kernels for the steady-state sweep, hand-written for
// Hopper (sm_90a). Built by pycatkin_tpu_torch/ops/cuda_linalg.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through the plain C entry points at the bottom (ctypes).
//
// What each kernel replaces (pycatkin_tpu/ops/pallas_linalg.py):
//   pk_lu_factor    <- lu_factor    (_lu_kernel + _factor_body)
//   pk_lu_solve     <- lu_solve     (_lu_solve_kernel + _permute_rhs +
//                                    _solve_body)
//   pk_factor_solve <- factor_solve (_factor_solve_kernel)
//
// Arithmetic contract (the one the Pallas bodies and
// pycatkin_tpu/ops/linalg.py _lu_step / lu_solve share), at every n:
//   * partial pivoting; the pivot of column k is the FIRST row r >= k
//     attaining max |A[r, k]| (ties go to the smallest row index);
//   * multipliers A[i, k] / A[k, k] (an IEEE division) are stored below
//     the diagonal, the rank-1 update is A[i, j] - f_i * A[k, j] rounded
//     as a separate multiply and subtract (__dmul_rn / __dsub_rn: no FMA
//     contraction), and entry (i, j) takes its updates in ascending k,
//     k = 0 .. min(i, j) - 1, so LU and perm match the plain PyTorch
//     version bit for bit. (The panel tier below orders the work between
//     entries differently, never the updates of one entry.)
//   * perm[r] is the original row now at row r (int32); solves apply
//     b[perm], a unit-lower forward pass, then an upper backward pass.
//   The substitution passes here are column-oriented (each finished
//   unknown is subtracted from the rows still open, in ascending order
//   forward and descending order backward), so x agrees with the
//   row-dot recurrences of the plain version to rounding order only, and
//   every tier below computes the same x bit for bit.
//   A singular or NaN lane divides by a zero / NaN pivot and comes out
//   non-finite; lanes never touch each other's data. NaN never wins a
//   pivot search; an all-NaN column keeps row k.
//
// What bounds the work on an H100. A lane moves ~2*n*n*8 bytes (matrix
// in, factors out) against ~(2/3)n^3 FP64 operations: ~1.3 operations
// per byte at n = 32, far below the card's FP64 ridge (~20), so every
// small-n kernel is bound by memory traffic in principle, and by the n-1
// dependent elimination steps (latency) and the instructions each step
// issues in practice. At larger n the trailing updates dominate
// ((1/3) n^3 of them), and with them the bytes that cross HBM. Three
// tiers:
//
//   * warp tier (lu_factor and factor_solve at the bucket widths n = 16
//     and 32): one group of n threads per lane (a half-warp or a warp),
//     eight or four lanes per 128-thread block. Thread r keeps row r in
//     registers (n is a template argument and the loops over columns and
//     steps are unrolled, so the row never leaves registers and no index
//     needs a run-time bound check). Rows are never
//     exchanged: each thread tracks its row's position in the pivoted
//     order instead. The pivot search is an integer max-reduction
//     (__reduce_max_sync) of the high words plus a ballot for the row
//     attaining it (low words and positions decide ties); the pivot row
//     travels through a per-group shared row read back with same-address
//     (broadcast) 16-byte loads, since a shuffle moves a double as two
//     32-bit halves. Every collective is taken by the whole warp: with a
//     half-warp mask the card runs it once per half, one after the other.
//     No block barrier: a warp past the last lane returns. The lane's
//     contiguous n*n block is staged coalesced through an odd-stride
//     shared tile, in and out. factor_solve then substitutes in
//     registers too: each thread holds y at its row's position, and each
//     finished unknown is broadcast by a shuffle.
//   * block tier, resident (every other n while a lane fits the card's
//     opt-in shared memory, n <= 169 at k = 1 on an H100): one block per
//     lane, the
//     matrix in shared memory at an odd row stride (so a column walk hits
//     distinct banks), warp 0 searches the pivot, each warp divides up to
//     32 multipliers at once and updates whole rows with its threads on
//     the columns, three block barriers a step; factor_solve's
//     substitution then runs in warp 0 alone (no block barriers).
//   * panel tier (larger n: the lane's matrix stays in device memory, in
//     LU itself for lu_factor and in a workspace the wrapper allocates
//     for factor_solve): one block per lane factors b = 32 columns at a
//     time, right-looking. An unblocked step would move the whole
//     trailing submatrix through HBM (~89 MB a lane at n = 256, more
//     than L2 holds across the resident lanes); a panel step moves it
//     once per b columns. Each panel:
//       1. its columns, rows k0.., are staged into shared memory and
//          factored there with one block barrier a step: rows are never
//          exchanged, each thread owns rows and tracks their positions
//          (as the warp tier does), and the pivot is a (|a|, position)
//          max-reduction, per warp by shuffles and then across warps;
//       2. the panel goes back by position, and the panel's row order
//          is applied to the columns left of it (through a shared stash
//          of the moved rows);
//       3. the columns right of it, in chunks of c: the moved rows are
//          stashed, the U rows formed in the stash against the unit-lower
//          panel (a warp per 8 columns, lane r on row r, ascending k),
//          and each thread loads a 4 x 4 tile of the trailing rows once,
//          applies the b updates in ascending k from the shared panel
//          and U chunk, and writes it once.
//     The first panel reads the input out of place (its trailing rows
//     through the position map), so nothing copies A first. The
//     contract forbids FMA, so the FP64 tensor cores (DMMA fuses the
//     multiply-add) are out: the floor is two vector instructions per
//     update. b (32 down to 1) and c (64, 32, 16) are the shape that
//     keeps the most lanes on an SM (b = 16 at n = 512). factor_solve
//     then substitutes in warp 0, as the block tier does, with y in
//     shared memory and the factors in device memory.
//   lu_solve is one block per lane at every n: the factors in device
//   memory, the permuted right-hand side in shared memory.
//   The right-hand sides [n, nrhs] stay in shared memory on every tier
//   but the warp tier: lu_solve needs n*nrhs*8 bytes and a panel-tier
//   factor_solve n*nrhs*8 + 4n within the opt-in limit (227 KB on an
//   H100, e.g. nrhs <= 56 at n = 512; the panel's working set is reused
//   for them); a larger launch is refused with a CUDA error, which the
//   wrappers raise. The sweep's solves take nrhs = 1.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ double upd(double a, double f, double u) {
  return __dsub_rn(a, __dmul_rn(f, u));
}

// ---------------------------------------------------------------------
// Warp tier: n == NP (16 or 32), one group of NP threads per lane.

constexpr int kWarpTierThreads = 128;
constexpr unsigned kFullWarp = 0xffffffffu;

// Collectives over this thread's group of NP lanes, taken by the whole
// warp at once (all its threads call them together): a collective with a
// half-warp mask runs once per half-warp group, one after the other.
//
// The maximum of `v` over the group; a half-warp group reduces the warp
// twice, the other half contributing `neutral`.
template <int NP, typename T>
__device__ __forceinline__ T group_max(T v, T neutral) {
  if constexpr (NP == 32) {
    return __reduce_max_sync(kFullWarp, v);
  } else {
    const bool upper = (threadIdx.x & 16) != 0;
    const T lower_max = __reduce_max_sync(kFullWarp, upper ? neutral : v);
    const T upper_max = __reduce_max_sync(kFullWarp, upper ? v : neutral);
    return upper ? upper_max : lower_max;
  }
}

// Whether `pred` holds anywhere in the warp (a branch on it is taken by
// both half-warp groups together); a whole-warp group's ballot already
// is warp-uniform.
template <int NP>
__device__ __forceinline__ bool warp_any(bool pred) {
  if constexpr (NP == 32) {
    return pred;
  } else {
    return __any_sync(kFullWarp, pred);
  }
}

// Bit i set where `pred` holds on the group's i-th thread.
template <int NP>
__device__ __forceinline__ unsigned group_ballot(bool pred) {
  const unsigned bits = __ballot_sync(kFullWarp, pred);
  if constexpr (NP == 32) {
    return bits;
  } else {
    return (bits >> (threadIdx.x & 16)) & 0xffffu;
  }
}

// Factor each lane of A [lanes, NP, NP]. Without kSolve the factors go
// to LU and the permutation to perm; with kSolve b [lanes, NP, nrhs] is
// solved into x and the factors never leave registers.
//
// Rows are never exchanged: thread r keeps row r and its position `pos`
// in the pivoted order. Step k swaps the positions of the pivot row and
// the row at position k, and every row at a position past k takes the
// update -- the operations the exchanging algorithm applies to each row,
// in the same order, so LU and perm come out bit for bit the same.
template <int NP, bool kSolve>
__device__ __forceinline__ void lu_warp(const double* __restrict__ A,
                                        double* __restrict__ LU,
                                        int* __restrict__ perm,
                                        const double* __restrict__ b,
                                        double* __restrict__ x,
                                        long long lanes, int nrhs) {
  constexpr int n = NP;
  constexpr int LD = NP + 1;  // odd tile stride: row reads hit distinct banks
  extern __shared__ double smem[];
  const int g = threadIdx.x / NP;
  const int r = threadIdx.x % NP;  // the row this thread keeps
  const long long first =
      static_cast<long long>(blockIdx.x) * (kWarpTierThreads / NP);
  // The last block's spare warps return; a spare half-warp group still
  // takes part in its warp's collectives but touches no memory.
  if (first + (threadIdx.x & ~31) / NP >= lanes) return;
  const long long lane = first + g;
  const bool live = lane < lanes;
  double* tile = smem + g * NP * LD;
  constexpr long long nn = static_cast<long long>(n) * n;

  // Stage the lane's contiguous block row by row (coalesced) through the
  // tile, every load in flight at once, then each thread takes its own
  // row into registers.
  if (live) {
    const double* src = A + lane * nn;
#pragma unroll
    for (int i = 0; i < n; ++i) tile[i * LD + r] = src[i * n + r];
  }
  __syncwarp();
  double a[NP];
#pragma unroll
  for (int j = 0; j < n; ++j) a[j] = live ? tile[r * LD + j] : 0.0;
  __syncwarp();

  // From here the tile holds the pivot row, double-buffered by the parity
  // of the step, so one __syncwarp a step orders its write before the
  // reads of the same step and after the reads two steps back.
  int pos = r;
#pragma unroll
  for (int k = 0; k < n - 1; ++k) {
    // Pivot: max |a_rk| over the rows at positions k..n-1, the first
    // position on a tie; NaN is no candidate. A non-negative double
    // orders as its (high word, low word) pair, so a max-reduction of
    // the high words decides unless they tie. The tie branches are
    // taken by the whole warp when either of its groups needs them.
    // Non-candidates take -2 and the row at position k -1 (so an
    // all-NaN column keeps it).
    const double v = fabs(a[k]);
    const bool cand = pos >= k && v > -1.0;
    const int hi = cand ? __double2hiint(v) : (pos == k ? -1 : -2);
    const int max_hi = group_max<NP>(hi, -2);  // (never short-circuited)
    bool top = hi == max_hi;
    unsigned hit = group_ballot<NP>(top);
    if (warp_any<NP>(hit & (hit - 1))) {
      const unsigned lo =
          top ? static_cast<unsigned>(__double2loint(v)) : 0u;
      const unsigned max_lo = group_max<NP>(lo, 0u);
      top = top && lo == max_lo;
      hit = group_ballot<NP>(top);
      if (warp_any<NP>(hit & (hit - 1))) {
        const int key = top ? NP - pos : 0;  // the first position wins
        const int max_key = group_max<NP>(key, 0);
        top = top && key == max_key;
        hit = group_ballot<NP>(top);
      }
    }
    const int q = __ffs(static_cast<int>(hit)) - 1;
    const int q_pos = __shfl_sync(kFullWarp, pos, q, NP);
    if (pos == k) pos = q_pos;
    if (r == q) pos = k;
    // The pivot row's columns k.. go to the tile, read back with
    // same-address 16-byte loads.
    double* pb = tile + (k & 1) * NP;
    if (r == q) {
#pragma unroll
      for (int j = k & ~1; j < NP; j += 2)
        reinterpret_cast<double2*>(pb)[j >> 1] = make_double2(a[j], a[j + 1]);
    }
    __syncwarp();
    if (pos > k) {
      const double f = a[k] / pb[k];
      a[k] = f;
#pragma unroll
      for (int j = (k + 1) & ~1; j < NP; j += 2) {
        const double2 u = reinterpret_cast<const double2*>(pb)[j >> 1];
        if (j > k) a[j] = upd(a[j], f, u.x);
        a[j + 1] = upd(a[j + 1], f, u.y);
      }
    }
  }

  if constexpr (!kSolve) {
    __syncwarp();  // the last step's pivot row is read; reuse the tile
#pragma unroll
    for (int j = 0; j < n; ++j) tile[pos * LD + j] = a[j];
    __syncwarp();
    if (live) {
      double* dst = LU + lane * nn;
#pragma unroll
      for (int i = 0; i < n; ++i) dst[i * n + r] = tile[i * LD + r];
      perm[lane * n + pos] = r;
    }
  } else {
    // Thread r holds y at its row's position, b[r] to begin with (b[perm]
    // in pivoted order), and each finished unknown is broadcast from the
    // thread at its position (at[i], the inverse permutation, gathered
    // once through the tile); the update order is lu_solve_kernel's.
    int* inv = reinterpret_cast<int*>(tile + 2 * NP);
    inv[pos] = r;
    __syncwarp();
    int at[NP];
#pragma unroll
    for (int i = 0; i < n; ++i) at[i] = inv[i];
    const long long nk = static_cast<long long>(n) * nrhs;
    for (int c = 0; c < nrhs; ++c) {
      double y =
          live ? b[lane * nk + static_cast<long long>(r) * nrhs + c] : 0.0;
#pragma unroll
      for (int i = 0; i < n - 1; ++i) {
        const double yi = __shfl_sync(kFullWarp, y, at[i], NP);
        if (pos > i) y = upd(y, a[i], yi);
      }
#pragma unroll
      for (int i = n - 1; i >= 0; --i) {
        if (pos == i) y = y / a[i];
        const double yi = __shfl_sync(kFullWarp, y, at[i], NP);
        if (pos < i) y = upd(y, a[i], yi);
      }
      if (live) x[lane * nk + static_cast<long long>(pos) * nrhs + c] = y;
    }
  }
}

template <int NP, bool kSolve>
__global__ void __launch_bounds__(kWarpTierThreads)
lu_warp_kernel(const double* __restrict__ A, double* __restrict__ LU,
               int* __restrict__ perm, const double* __restrict__ b,
               double* __restrict__ x, long long lanes, int nrhs) {
  lu_warp<NP, kSolve>(A, LU, perm, b, x, lanes, nrhs);
}

// lu_factor at n = 32 (the ABI flagship's direction solves): at most 102
// registers a thread, so five blocks share an SM (a few spilled values
// cost less than the lost occupancy, on an H100).
__global__ void __launch_bounds__(kWarpTierThreads, 5)
lu_factor_warp32_kernel(const double* __restrict__ A, double* __restrict__ LU,
                        int* __restrict__ perm, long long lanes) {
  lu_warp<32, false>(A, LU, perm, nullptr, nullptr, lanes, 0);
}

// ---------------------------------------------------------------------
// Block tier: one block per lane.

// Threads per block of the solve (warp 0 runs the pivot search, so at
// least one full warp) and of the block-tier factorization.
inline int solve_threads(int n) {
  if (n <= 16) return 64;
  if (n <= 32) return 128;
  return 256;
}

// Six 256-thread blocks fit an SM's registers (at most 42 a thread): at
// n = 64 shared memory admits six lanes an SM, and the registers must too.
constexpr int min_blocks(int threads) { return threads == 256 ? 6 : 1; }

// Row stride of a matrix resident in shared memory: odd, so the 8-byte
// entries of one column fall on distinct bank pairs.
__host__ __device__ inline int smem_ld(int n) { return n | 1; }

// Copy an n x n matrix between row strides: warps over rows, threads
// over columns (coalesced).
__device__ void copy_matrix(const double* src, int lds, double* dst, int ldd,
                            int n) {
  const int nw = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < n; i += nw)
    for (int j = threadIdx.x & 31; j < n; j += 32)
      dst[i * ldd + j] = src[i * lds + j];
}

// In-place partial-pivoted LU of one lane's [n, n] matrix `a` (row
// stride `ld`, in shared memory). `perm` ([n] int, shared)
// receives the permutation. Expects `a` complete (a barrier after the
// load); ends with a barrier.
__device__ void factor_lane(double* a, int ld, int* perm, int n) {
  __shared__ int s_pivot;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nw = nt >> 5;
  for (int i = tid; i < n; i += nt) perm[i] = i;
  for (int k = 0; k < n - 1; ++k) {
    if (warp == 0) {
      // Each lane of warp 0 scans rows k+lane, k+lane+32, ... in
      // increasing order keeping the first maximum; the shuffle
      // reduction then prefers the larger value, the smaller row on a
      // tie. NaN entries never win; an all-NaN column keeps row k.
      double best = -1.0;
      int row = n;
      for (int r = k + lane; r < n; r += 32) {
        const double v = fabs(a[r * ld + k]);
        if (v > best) {
          best = v;
          row = r;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const double ov = __shfl_down_sync(0xffffffffu, best, off);
        const int orow = __shfl_down_sync(0xffffffffu, row, off);
        if (ov > best || (ov == best && orow < row)) {
          best = ov;
          row = orow;
        }
      }
      if (lane == 0) s_pivot = row < n ? row : k;
    }
    __syncthreads();
    const int p = s_pivot;
    if (p != k) {
      for (int j = tid; j < n; j += nt) {
        const double t = a[k * ld + j];
        a[k * ld + j] = a[p * ld + j];
        a[p * ld + j] = t;
      }
      if (tid == 0) {
        const int t = perm[k];
        perm[k] = perm[p];
        perm[p] = t;
      }
      __syncthreads();
    }
    // Warp w updates rows k+1+w, k+1+w+nw, ...: for up to 32 of them at
    // a time, each thread divides one row's column-k entry (the divisions
    // run in parallel) and stores the multiplier over it; then, row by
    // row, the multiplier is broadcast and the threads walk the columns.
    const double* u = a + k * ld;
    const double pivot = u[k];
    for (int base = k + 1 + warp; base < n; base += 32 * nw) {
      const int mine = base + lane * nw;
      double f = 0.0;
      if (mine < n) {
        f = a[mine * ld + k] / pivot;
        a[mine * ld + k] = f;
      }
      const int rows = min(32, (n - base + nw - 1) / nw);
#pragma unroll 4
      for (int t = 0; t < rows; ++t) {
        const double ft = __shfl_sync(0xffffffffu, f, t);
        double* row = a + (base + t * nw) * ld;
        for (int j = k + 1 + lane; j < n; j += 32)
          row[j] = upd(row[j], ft, u[j]);
      }
    }
    __syncthreads();
  }
}

// Solve (LU) x = y in place for one lane: `lu` is the [n, n]
// factorization at row stride `ld` (device memory), `y` the
// permuted right-hand sides [n, nrhs] in shared memory.
__device__ void solve_lane(const double* lu, int ld, double* y, int n,
                           int nrhs) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = 0; i < n - 1; ++i) {
    const int count = (n - 1 - i) * nrhs;
    for (int e = tid; e < count; e += nt) {
      const int j = i + 1 + e / nrhs;
      const int c = e % nrhs;
      y[j * nrhs + c] = upd(y[j * nrhs + c], lu[j * ld + i], y[i * nrhs + c]);
    }
    __syncthreads();
  }
  for (int i = n - 1; i >= 0; --i) {
    const double d = lu[i * ld + i];
    for (int c = tid; c < nrhs; c += nt) y[i * nrhs + c] = y[i * nrhs + c] / d;
    __syncthreads();
    const int count = i * nrhs;
    for (int e = tid; e < count; e += nt) {
      const int j = e / nrhs;
      const int c = e % nrhs;
      y[j * nrhs + c] = upd(y[j * nrhs + c], lu[j * ld + i], y[i * nrhs + c]);
    }
    __syncthreads();
  }
}

// solve_lane's arithmetic, in the same order, run by warp 0 alone: no
// block barrier per step, only __syncwarp (the other warps idle).
__device__ void solve_lane_warp(const double* lu, int ld, double* y, int n,
                                int nrhs) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  for (int c = 0; c < nrhs; ++c) {
    for (int i = 0; i < n - 1; ++i) {
      const double yi = y[i * nrhs + c];
      for (int j = i + 1 + lane; j < n; j += 32)
        y[j * nrhs + c] = upd(y[j * nrhs + c], lu[j * ld + i], yi);
      __syncwarp();
    }
    for (int i = n - 1; i >= 0; --i) {
      if (lane == 0) y[i * nrhs + c] = y[i * nrhs + c] / lu[i * ld + i];
      __syncwarp();
      const double yi = y[i * nrhs + c];
      for (int j = lane; j < i; j += 32)
        y[j * nrhs + c] = upd(y[j * nrhs + c], lu[j * ld + i], yi);
      __syncwarp();
    }
  }
}

// y = b[perm] for one lane (shared memory), then a barrier.
__device__ void gather_rhs(const double* bl, const int* p, double* y, int n,
                           int nrhs) {
  for (int e = threadIdx.x; e < n * nrhs; e += blockDim.x) {
    const int r = e / nrhs;
    const int c = e % nrhs;
    y[e] = bl[p[r] * nrhs + c];
  }
  __syncthreads();
}

// The shared-memory block tier: the lane's matrix lives in shared memory
// at an odd row stride, between one coalesced copy in and one out.
template <int kThreads>
__global__ void __launch_bounds__(kThreads, min_blocks(kThreads))
lu_factor_kernel(const double* __restrict__ A, double* LU,
                 int* __restrict__ perm, int n) {
  extern __shared__ double smem[];
  const long long lane = blockIdx.x;
  const long long nn = static_cast<long long>(n) * n;
  const int ld = smem_ld(n);
  int* p = reinterpret_cast<int*>(smem + n * ld);
  copy_matrix(A + lane * nn, n, smem, ld, n);
  __syncthreads();
  factor_lane(smem, ld, p, n);
  copy_matrix(smem, ld, LU + lane * nn, n, n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) perm[lane * n + i] = p[i];
}

__global__ void lu_solve_kernel(const double* __restrict__ LU,
                                const int* __restrict__ perm,
                                const double* __restrict__ b,
                                double* __restrict__ x, int n, int nrhs) {
  extern __shared__ double smem[];
  double* y = smem;
  const long long lane = blockIdx.x;
  const long long nk = static_cast<long long>(n) * nrhs;
  gather_rhs(b + lane * nk, perm + lane * n, y, n, nrhs);
  solve_lane(LU + lane * static_cast<long long>(n) * n, n, y, n, nrhs);
  double* xl = x + lane * nk;
  for (int e = threadIdx.x; e < n * nrhs; e += blockDim.x) xl[e] = y[e];
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads, min_blocks(kThreads))
factor_solve_kernel(const double* __restrict__ A,
                    const double* __restrict__ b, double* __restrict__ x,
                    int n, int nrhs) {
  extern __shared__ double smem[];
  const long long lane = blockIdx.x;
  const long long nn = static_cast<long long>(n) * n;
  const long long nk = static_cast<long long>(n) * nrhs;
  const int ld = smem_ld(n);
  double* y = smem + n * ld;
  int* p = reinterpret_cast<int*>(y + n * nrhs);
  copy_matrix(A + lane * nn, n, smem, ld, n);
  __syncthreads();
  factor_lane(smem, ld, p, n);
  gather_rhs(b + lane * nk, p, y, n, nrhs);
  solve_lane_warp(smem, ld, y, n, nrhs);
  if (threadIdx.x >= 32) return;
  double* xl = x + lane * nk;
  for (int e = threadIdx.x; e < n * nrhs; e += 32) xl[e] = y[e];
}

// Opt a kernel into more than 48 KB of dynamic shared memory when the
// launch needs it (refused above the card's opt-in limit).
template <typename K>
cudaError_t reserve_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// Dynamic shared memory one block may opt into on the current device
// (232,448 bytes on an H100); 0 when the device cannot be queried.
long long smem_optin() {
  int dev = 0;
  int bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

// ---------------------------------------------------------------------
// Panel tier: one block per lane, the matrix in device memory.

constexpr int kPanelThreads = 256;
constexpr int kPanelWarps = kPanelThreads / 32;
constexpr int kPanelB = 32;  // panel width
constexpr int kPanelC = 64;  // column chunk of the trailing update

// Shared memory of the panel tier in bytes, the permutation left out:
// the panel (n rows at the odd stride b | 1), the stash of up to 2b
// moved rows by c columns (stride c + 1), each row's position and the
// row at each position, the moved positions and their permutation
// entries.
inline long long panel_work_bytes(int n, int b, int c) {
  return 8LL * (static_cast<long long>(n) * (b | 1) + 2LL * b * (c + 1)) +
         4LL * (2LL * n + 4LL * b);
}

// The panel tier's shape for one launch: b = 0 where even b = 1 does
// not fit. The permutation sits past both the working set and the
// right-hand sides, which reuse the working set's memory after the
// factorization; `bytes` is the launch's dynamic shared memory.
struct PanelPlan {
  int b = 0, c = 0;
  long long perm_off = 0, bytes = 0;
};

// Of the shapes that fit `limit`, the one that keeps the most blocks
// (lanes) on an SM, and among those the widest panel, then the widest
// chunk. (At n = 512 a panel of 16 lets two lanes share an SM where a
// panel of 32 leaves one; each lane's stretches of pivot searches and
// barriers then overlap the other's trailing updates.)
template <typename K>
PanelPlan panel_plan(K kernel, int n, int nrhs, long long limit) {
  PanelPlan plan;
  int most = 0;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return plan;
  const long long room = limit - static_cast<long long>(attr.sharedSizeBytes);
  if (reserve_smem(kernel, static_cast<size_t>(room)) != cudaSuccess)
    return plan;
  for (int b = kPanelB; b >= 1; b >>= 1) {
    for (int c = kPanelC; c >= 16; c >>= 1) {
      const long long work = panel_work_bytes(n, b, c);
      const long long off = work > 8LL * n * nrhs ? work : 8LL * n * nrhs;
      const long long bytes = off + 4LL * n;
      int blocks = 0;
      if (bytes > room ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &blocks, kernel, kPanelThreads,
              static_cast<size_t>(bytes)) != cudaSuccess ||
          blocks <= most)
        continue;
      most = blocks;
      plan.b = b;
      plan.c = c;
      plan.perm_off = off;
      plan.bytes = bytes;
    }
  }
  return plan;
}

// dst(e, j) = src(e, j) for e < rows, j < w: the threads over the
// flattened block (consecutive threads on consecutive columns), four
// loads in flight each.
template <typename Src, typename Dst>
__device__ __forceinline__ void copy_block(int rows, int w, Src src,
                                           Dst dst) {
  const int total = rows * w;
  for (int base = threadIdx.x; base < total; base += 4 * kPanelThreads) {
    double v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = base + t * kPanelThreads;
      if (i < total) v[t] = src(i / w, i % w);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = base + t * kPanelThreads;
      if (i < total) dst(i / w, i % w) = v[t];
    }
  }
}

// Whether pivot candidate (key, at) beats (best, best_at): the larger
// key, the smaller position on a tie. `at` packs a candidate's position
// (high 16 bits) and row (low 16: the tier's shared memory keeps n
// below 12,000).
__device__ __forceinline__ bool pivot_beats(double key, int at, double best,
                                            int best_at) {
  return key > best || (key == best && at < best_at);
}

// U rows of one column chunk: the stash rows 0..bw-1 of its w columns
// (the panel's row order already applied) against the unit-lower panel,
// each entry's updates in ascending k. A warp per 8 columns, lane r on
// row r; the result goes to the stash and to `a` (rows k0 .., columns
// c0 ..).
__device__ void panel_u_rows(const double* P, int ldp, const int* at,
                             double* S, int lds, double* a, int n, int k0,
                             int bw, int c0, int w) {
  const int r = threadIdx.x & 31;
  const bool live = r < bw;
  const double* l = P + (live ? at[r] : 0) * ldp;
  for (int g = (threadIdx.x >> 5) * 8; g < w; g += kPanelWarps * 8) {
    double v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t)
      v[t] = live && g + t < w ? S[r * lds + g + t] : 0.0;
    for (int q = 0; q + 1 < bw; ++q) {
      const double lq = l[q];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const double uq = __shfl_sync(kFullWarp, v[t], q);
        if (r > q && live) v[t] = upd(v[t], lq, uq);
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (live && g + t < w) {
        S[r * lds + g + t] = v[t];
        a[(k0 + r) * n + c0 + g + t] = v[t];
      }
    }
  }
}

// Trailing rows bw..m-1 (of the panel's m) of one column chunk: each
// warp takes 16 x 32 tiles, each thread a 4 x 4 tile (rows 4 apart,
// columns 8 apart) loaded once, updated by the bw panel columns in
// ascending k and written once. `from` holds the chunk before the update:
// `a`, or the input in the first panel (`remap`), whose rows are read
// through the position map `at`.
__device__ void panel_trailing(const double* P, int ldp, const int* at,
                               const double* S, int lds, const double* from,
                               bool remap, double* a, int n, int k0, int bw,
                               int m, int c0, int w) {
  const int lane = threadIdx.x & 31;
  const int rg = lane >> 3;
  const int cl = lane & 7;
  const int col_tiles = (w + 31) / 32;
  const int tiles = (m - bw + 15) / 16 * col_tiles;
  for (int t = threadIdx.x >> 5; t < tiles; t += kPanelWarps) {
    const int i0 = bw + t / col_tiles * 16 + rg;
    const int j0 = t % col_tiles * 32 + cl;
    const double* lrow[4];
    const double* in[4];
    double* out[4];
    bool row_ok[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      row_ok[p] = i0 + 4 * p < m;
      const int i = row_ok[p] ? i0 + 4 * p : bw;
      lrow[p] = P + at[i] * ldp;
      in[p] = from + (k0 + (remap ? at[i] : i)) * n + c0;
      out[p] = a + (k0 + i) * n + c0;
    }
    int col[4];
    bool col_ok[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      col_ok[q] = j0 + 8 * q < w;
      col[q] = col_ok[q] ? j0 + 8 * q : w - 1;
    }
    double acc[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = in[p][col[q]];
#pragma unroll 4
    for (int k = 0; k < bw; ++k) {
      double l[4], u[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) l[p] = lrow[p][k];
#pragma unroll
      for (int q = 0; q < 4; ++q) u[q] = S[k * lds + col[q]];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = upd(acc[p][q], l[p], u[q]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (row_ok[p] && col_ok[q]) out[p][col[q]] = acc[p][q];
  }
}

// Partial-pivoted LU of one lane's [n, n] matrix `in` into `a` (device
// memory, row stride n; `in` is only read), b columns at a time (see
// the header); `perm` ([n] int, shared) receives the permutation and
// `smem` holds panel_work_bytes(n, b, c). Ends with a barrier.
__device__ void factor_panels(const double* __restrict__ in, double* a,
                              int n, int b, int c, double* smem, int* perm) {
  __shared__ double red_key[2][kPanelWarps];
  __shared__ int red_at[2][kPanelWarps];
  __shared__ int s_moved;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ldp = b | 1;
  const int lds = c + 1;
  double* P = smem;
  double* S = P + n * ldp;
  int* pos = reinterpret_cast<int*>(S + 2 * b * lds);  // of each panel row
  int* at = pos + n;                                   // row at a position
  int* moved = at + n;  // positions 0..bw-1, then the others that moved
  int* moved_perm = moved + 2 * b;
  for (int i = tid; i < n; i += kPanelThreads) perm[i] = i;
  for (int k0 = 0; k0 < max(n - 1, 1); k0 += b) {
    const int m = n - k0;
    const int bw = min(b, m);
    const double* from = k0 == 0 ? in : a;

    // 1. Stage the panel and factor it in shared memory. Thread t owns
    // rows t, t + 256, ...; rows are never exchanged, pos[r] is row r's
    // position in the pivoted order.
    copy_block(
        m, bw, [&](int r, int j) { return from[(k0 + r) * n + k0 + j]; },
        [&](int r, int j) -> double& { return P[r * ldp + j]; });
    for (int r = tid; r < m; r += kPanelThreads) pos[r] = r;
    __syncthreads();
    for (int k = 0; k < min(bw, m - 1); ++k) {
      // Pivot: max |a| over positions k.., the first position on a tie.
      // NaN is no candidate: non-candidates key -2, the row at position
      // k -1 (an all-NaN column keeps it). Each thread reads only its
      // own rows, which it updated itself, so one barrier a step orders
      // the updates before the reads of the next pivot row.
      double best = -3.0;
      int best_at = m << 16;
      for (int r = tid; r < m; r += kPanelThreads) {
        const int p = pos[r];
        if (p < k) continue;
        const double v = fabs(P[r * ldp + k]);
        const double key = v >= 0.0 ? v : (p == k ? -1.0 : -2.0);
        if (pivot_beats(key, p << 16 | r, best, best_at)) {
          best = key;
          best_at = p << 16 | r;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const double o_key = __shfl_xor_sync(kFullWarp, best, off, 32);
        const int o_at = __shfl_xor_sync(kFullWarp, best_at, off, 32);
        if (pivot_beats(o_key, o_at, best, best_at)) {
          best = o_key;
          best_at = o_at;
        }
      }
      const int s = k & 1;  // double-buffered: one barrier a step
      if (lane == 0) {
        red_key[s][warp] = best;
        red_at[s][warp] = best_at;
      }
      __syncthreads();
      best = red_key[s][0];
      best_at = red_at[s][0];
#pragma unroll
      for (int w = 1; w < kPanelWarps; ++w) {
        if (pivot_beats(red_key[s][w], red_at[s][w], best, best_at)) {
          best = red_key[s][w];
          best_at = red_at[s][w];
        }
      }
      const int best_pos = best_at >> 16;
      const int best_row = best_at & 0xffff;
      const double* u = P + best_row * ldp;
      const double pivot = u[k];
      for (int r = tid; r < m; r += kPanelThreads) {
        int p = pos[r];
        if (p == k) p = best_pos;
        if (r == best_row) p = k;
        pos[r] = p;
        if (p <= k) continue;
        double* row = P + r * ldp;
        const double f = row[k] / pivot;
        row[k] = f;
        for (int j0 = k + 1; j0 < bw; j0 += 8) {  // eight loads in flight
          double v[8], uj[8];
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            if (j0 + t < bw) {
              v[t] = row[j0 + t];
              uj[t] = u[j0 + t];
            }
          }
#pragma unroll
          for (int t = 0; t < 8; ++t)
            if (j0 + t < bw) row[j0 + t] = upd(v[t], f, uj[t]);
        }
      }
    }
    __syncthreads();

    // 2. The position map, the moved positions, the panel back to `a` by
    // position, the permutation.
    for (int r = tid; r < m; r += kPanelThreads) at[pos[r]] = r;
    for (int e = tid; e < bw; e += kPanelThreads) moved[e] = e;
    if (tid == 0) s_moved = bw;
    __syncthreads();
    for (int r = tid; r < m; r += kPanelThreads)
      if (pos[r] >= bw && pos[r] != r) moved[atomicAdd(&s_moved, 1)] = pos[r];
    copy_block(
        m, bw, [&](int r, int j) { return P[r * ldp + j]; },
        [&](int r, int j) -> double& { return a[(k0 + pos[r]) * n + k0 + j]; });
    __syncthreads();
    const int n_moved = s_moved;
    for (int e = tid; e < n_moved; e += kPanelThreads)
      moved_perm[e] = perm[k0 + at[moved[e]]];
    __syncthreads();
    for (int e = tid; e < n_moved; e += kPanelThreads)
      perm[k0 + moved[e]] = moved_perm[e];

    // 3. The panel's row order on the columns left of it: the moved rows
    // through the stash.
    auto stash = [&](int e, int j) -> double& { return S[e * lds + j]; };
    for (int c0 = 0; c0 < k0; c0 += c) {
      const int w = min(c, k0 - c0);
      copy_block(
          n_moved, w,
          [&](int e, int j) { return a[(k0 + at[moved[e]]) * n + c0 + j]; },
          stash);
      __syncthreads();
      copy_block(
          n_moved, w, stash,
          [&](int e, int j) -> double& { return a[(k0 + moved[e]) * n + c0 + j]; });
      __syncthreads();
    }

    // 4. The columns right of it, chunk by chunk: the U rows (and, in
    // place, the other moved rows) through the stash, then the trailing
    // update.
    for (int c0 = k0 + bw; c0 < n; c0 += c) {
      const int w = min(c, n - c0);
      copy_block(
          k0 == 0 ? bw : n_moved, w,
          [&](int e, int j) { return from[(k0 + at[moved[e]]) * n + c0 + j]; },
          stash);
      __syncthreads();
      if (k0 > 0) {
        copy_block(
            n_moved - bw, w,
            [&](int e, int j) { return S[(bw + e) * lds + j]; },
            [&](int e, int j) -> double& {
              return a[(k0 + moved[bw + e]) * n + c0 + j];
            });
      }
      panel_u_rows(P, ldp, at, S, lds, a, n, k0, bw, c0, w);
      __syncthreads();
      panel_trailing(P, ldp, at, S, lds, from, k0 == 0, a, n, k0, bw, m, c0,
                     w);
      __syncthreads();
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kPanelThreads, 2)
lu_factor_panel_kernel(const double* __restrict__ A, double* __restrict__ LU,
                       int* __restrict__ perm, int n, int b, int c,
                       long long perm_off) {
  extern __shared__ double smem[];
  const long long lane = blockIdx.x;
  const long long nn = static_cast<long long>(n) * n;
  int* p = reinterpret_cast<int*>(reinterpret_cast<char*>(smem) + perm_off);
  factor_panels(A + lane * nn, LU + lane * nn, n, b, c, smem, p);
  for (int i = threadIdx.x; i < n; i += kPanelThreads)
    perm[lane * n + i] = p[i];
}

// Factors in the lane's n*n slice of `work`, then solves with the
// right-hand sides in the panel's shared memory (warp 0, as
// factor_solve_kernel), reading the factors in device memory.
__global__ void __launch_bounds__(kPanelThreads, 2)
factor_solve_panel_kernel(const double* __restrict__ A,
                          const double* __restrict__ b,
                          double* __restrict__ x, double* __restrict__ work,
                          int n, int nrhs, int pb, int c,
                          long long perm_off) {
  extern __shared__ double smem[];
  const long long lane = blockIdx.x;
  const long long nn = static_cast<long long>(n) * n;
  const long long nk = static_cast<long long>(n) * nrhs;
  int* p = reinterpret_cast<int*>(reinterpret_cast<char*>(smem) + perm_off);
  double* a = work + lane * nn;
  factor_panels(A + lane * nn, a, n, pb, c, smem, p);
  gather_rhs(b + lane * nk, p, smem, n, nrhs);
  solve_lane_warp(a, n, smem, n, nrhs);
  if (threadIdx.x >= 32) return;
  double* xl = x + lane * nk;
  for (int e = threadIdx.x; e < n * nrhs; e += 32) xl[e] = smem[e];
}

// Shared memory of one shared-memory block-tier factorization (nrhs = 0
// for lu_factor): the matrix, the right-hand sides, the permutation.
long long factor_smem(int n, int nrhs) {
  return (static_cast<long long>(n) * smem_ld(n) +
          static_cast<long long>(n) * nrhs) * 8 + n * 4LL;
}

// Shared-memory block tier launches: 256 threads a lane up to n = 128,
// 512 above.
template <int T>
cudaError_t launch_lu_factor(const double* A, double* LU, int* perm,
                             long long lanes, int n, size_t bytes,
                             cudaStream_t stream) {
  cudaError_t err = reserve_smem(lu_factor_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  lu_factor_kernel<T><<<static_cast<unsigned int>(lanes), T, bytes,
                        stream>>>(A, LU, perm, n);
  return cudaGetLastError();
}

template <int T>
cudaError_t launch_factor_solve(const double* A, const double* b, double* x,
                                long long lanes, int n, int nrhs,
                                size_t bytes, cudaStream_t stream) {
  cudaError_t err = reserve_smem(factor_solve_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  factor_solve_kernel<T><<<static_cast<unsigned int>(lanes), T, bytes,
                           stream>>>(A, b, x, n, nrhs);
  return cudaGetLastError();
}

// The warp tier at n == NP.
template <int NP, bool kSolve>
cudaError_t launch_warp(const double* A, double* LU, int* perm,
                        const double* b, double* x, long long lanes,
                        int nrhs, cudaStream_t stream) {
  constexpr int per_block = kWarpTierThreads / NP;
  const size_t bytes = sizeof(double) * kWarpTierThreads * (NP + 1);
  const unsigned int grid =
      static_cast<unsigned int>((lanes + per_block - 1) / per_block);
  if constexpr (NP == 32 && !kSolve) {
    cudaError_t err = reserve_smem(lu_factor_warp32_kernel, bytes);
    if (err != cudaSuccess) return err;
    lu_factor_warp32_kernel<<<grid, kWarpTierThreads, bytes, stream>>>(
        A, LU, perm, lanes);
  } else {
    cudaError_t err = reserve_smem(lu_warp_kernel<NP, kSolve>, bytes);
    if (err != cudaSuccess) return err;
    lu_warp_kernel<NP, kSolve><<<grid, kWarpTierThreads, bytes, stream>>>(
        A, LU, perm, b, x, lanes, nrhs);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Device workspace factor_solve needs, in doubles per lane: n*n where
// the lane's matrix does not fit shared memory, else 0.
long long pk_factor_solve_workspace(int n, int nrhs) {
  if (n == 16 || n == 32) return 0;
  return factor_smem(n, nrhs) > smem_optin()
             ? static_cast<long long>(n) * n
             : 0;
}

int pk_lu_factor(const double* A, double* LU, int* perm, long long lanes,
                 int n, void* stream) {
  if (n < 1 || lanes < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 16)
    return launch_warp<16, false>(A, LU, perm, nullptr, nullptr, lanes, 0, s);
  if (n == 32)
    return launch_warp<32, false>(A, LU, perm, nullptr, nullptr, lanes, 0, s);
  const long long limit = smem_optin();
  if (limit <= 0) return cudaErrorInvalidDevice;
  const size_t bytes = static_cast<size_t>(factor_smem(n, 0));
  if (static_cast<long long>(bytes) <= limit) {
    if (n <= 128)
      return launch_lu_factor<256>(A, LU, perm, lanes, n, bytes, s);
    return launch_lu_factor<512>(A, LU, perm, lanes, n, bytes, s);
  }
  const PanelPlan plan = panel_plan(lu_factor_panel_kernel, n, 0, limit);
  if (plan.b == 0) return cudaErrorInvalidValue;
  lu_factor_panel_kernel<<<static_cast<unsigned int>(lanes), kPanelThreads,
                           plan.bytes, s>>>(A, LU, perm, n, plan.b, plan.c,
                                            plan.perm_off);
  return cudaGetLastError();
}

int pk_lu_solve(const double* LU, const int* perm, const double* b,
                double* x, long long lanes, int n, int nrhs, void* stream) {
  if (n < 1 || nrhs < 1 || lanes < 1) return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(n) * nrhs * 8;
  cudaError_t err = reserve_smem(lu_solve_kernel, bytes);
  if (err != cudaSuccess) return err;
  lu_solve_kernel<<<static_cast<unsigned int>(lanes), solve_threads(n), bytes,
                    static_cast<cudaStream_t>(stream)>>>(LU, perm, b, x, n,
                                                         nrhs);
  return cudaGetLastError();
}

// `work`: pk_factor_solve_workspace(n, nrhs) doubles per lane, or
// nullptr where that is 0.
int pk_factor_solve(const double* A, const double* b, double* x,
                    double* work, long long lanes, int n, int nrhs,
                    void* stream) {
  if (n < 1 || nrhs < 1 || lanes < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 16)
    return launch_warp<16, true>(A, nullptr, nullptr, b, x, lanes, nrhs, s);
  if (n == 32)
    return launch_warp<32, true>(A, nullptr, nullptr, b, x, lanes, nrhs, s);
  const long long limit = smem_optin();
  if (limit <= 0) return cudaErrorInvalidDevice;
  const size_t bytes = static_cast<size_t>(factor_smem(n, nrhs));
  if (static_cast<long long>(bytes) <= limit) {
    if (n <= 128)
      return launch_factor_solve<256>(A, b, x, lanes, n, nrhs, bytes, s);
    return launch_factor_solve<512>(A, b, x, lanes, n, nrhs, bytes, s);
  }
  if (work == nullptr) return cudaErrorInvalidValue;
  const PanelPlan plan =
      panel_plan(factor_solve_panel_kernel, n, nrhs, limit);
  if (plan.b == 0) return cudaErrorInvalidValue;
  factor_solve_panel_kernel<<<static_cast<unsigned int>(lanes),
                              kPanelThreads, plan.bytes, s>>>(
      A, b, x, work, n, nrhs, plan.b, plan.c, plan.perm_off);
  return cudaGetLastError();
}

}  // extern "C"
