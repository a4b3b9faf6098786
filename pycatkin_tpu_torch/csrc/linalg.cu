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
// Each kernel is a template on its element type T: the Pallas kernels take
// any float type (their outputs take A's dtype), and the port runs them in
// float64 and, under the f32-polish precision tier's bulk march, in
// float32. pk_* take double, pk_*_f32 float; one body serves both.
//
// Arithmetic contract (the one the Pallas bodies and
// pycatkin_tpu/ops/linalg.py _lu_step / lu_solve share), at every n:
//   * partial pivoting; the pivot of column k is the FIRST row r >= k
//     attaining max |A[r, k]| (ties go to the smallest row index);
//   * multipliers A[i, k] / A[k, k] (an IEEE division) are stored below
//     the diagonal, the rank-1 update is A[i, j] - f_i * A[k, j] rounded
//     as a separate multiply and subtract (__dmul_rn / __dsub_rn, in
//     float __fmul_rn / __fsub_rn: no FMA contraction), and entry (i, j)
//     takes its updates in ascending k,
//     k = 0 .. min(i, j) - 1, so LU and perm match the plain PyTorch
//     version bit for bit. (The blocked tiers below order the work
//     between entries differently, never the updates of one entry.)
//   * perm[r] is the original row now at row r (int32); solves apply
//     b[perm], a unit-lower forward pass, then an upper backward pass.
//   The substitution passes are column-oriented: each entry of y takes
//   its updates in ascending order forward and descending order backward
//   and is divided after its last backward update. So x agrees with the
//   row-dot recurrences of the plain version to rounding order only, and
//   lu_solve(lu_factor(A), b) is factor_solve(A, b) bit for bit on every
//   tier.
//   A singular or NaN lane divides by a zero / NaN pivot and comes out
//   non-finite; lanes never touch each other's data. NaN never wins a
//   pivot search; an all-NaN column keeps row k.
//
// What bounds the work on an H100. A lane moves ~2*n*n*sizeof(T) bytes
// (matrix in, factors out) against ~(2/3)n^3 operations: in float64 ~1.3
// operations per byte at n = 32, far below the card's FP64 ridge (~20)
// (in float32 ~2.7 against ~20 as well), so every
// small-n kernel is bound by memory traffic in principle, and by the n-1
// dependent elimination steps (latency) and the instructions each step
// issues in practice. At larger n the trailing updates dominate
// ((1/3) n^3 of them): the contract forbids FMA, so the FP64 tensor cores
// (DMMA fuses the multiply-add) are out and the floor is two vector
// instructions per update, each fed from registers, not shared memory; in
// float32 the same two instructions on twice as many lanes an SM (128
// FP32 units to 64 FP64 ones).
// The tiers:
//
//   * warp tier (n = 16 and 32, the bucket widths; all three kernels):
//     one group of n threads per lane (a half-warp or a warp), eight or
//     four lanes per 128-thread block. Thread r keeps row r in registers
//     (n is a template argument and the loops are unrolled, so the row
//     never leaves registers). The lane's contiguous n*n block is staged
//     coalesced through an odd-stride shared tile, in and out. Rows are
//     never exchanged: each thread tracks its row's position in the
//     pivoted order. The pivot search is an integer max-reduction
//     (__reduce_max_sync) of the first words (a double's high word, a
//     float's bits) plus a ballot for the row attaining it (a double's
//     low words, then positions, decide ties); the pivot row travels
//     through a per-group shared row read back with same-address 16-byte
//     loads (double2 or float4). Every collective is taken by the whole warp: with a
//     half-warp mask the card runs it once per half. No block barrier: a
//     warp past the last lane returns. The substitution (factor_solve
//     after factoring, lu_solve on given factors) runs in registers too:
//     each thread holds y at its row's position, and each finished
//     unknown is broadcast by a shuffle (warp_forward / warp_backward).
//   * resident tier (lu_factor and factor_solve at every other n while
//     two lanes fit an SM's shared memory, n <= 119 at k = 1 on an H100
//     in float64, n <= 168 in float32):
//     one block per lane, the matrix in shared memory at an odd row
//     stride, factored 32 columns at a time, right-looking, rows never
//     exchanged. Each panel: its steps, one block barrier each (the pivot
//     a (|a|, position) max-reduction, per warp by shuffles and then
//     across warps through a double-buffered slot; each thread divides
//     and updates the panel columns of its own rows); then the U rows
//     right of it (a warp per 8 columns, lane r on row r, ascending k)
//     and the trailing rows in 4 x 4 register tiles, each loaded once,
//     given the panel's 32 updates in ascending k and stored once. LU
//     goes out by position and perm is the row at each position.
//     factor_solve then substitutes in warp 0 (no block barriers) with y
//     in shared memory. The boundary is measured
//     (pycatkin_tpu_torch/tools/tier_boundary.py builds a copy forcing
//     each tier; H100 80GB HBM3 at 700 W, ms resident / panel:
//     n = 64 x 4,096 0.6534 / 1.2881, n = 112 x 4,096 2.7389 / 3.1103,
//     n = 128 x 4,096 5.5583 / 3.5927, n = 165 x 2,048 4.4703 / 3.3190):
//     with one lane an SM the steps' latency (a barrier, a reduction
//     and a division chain each) is exposed and the panel tier, which
//     keeps two lanes an SM there, is faster; with two or more the
//     resident tier is. It takes 128 threads where three or
//     more lanes fit (their registers then admit all of them), 256 where
//     two do.
//   * panel tier (larger n: the lane's matrix stays in device memory, in
//     LU itself for lu_factor and in a workspace the wrapper allocates
//     for factor_solve): the same panel step on a panel staged into
//     shared memory. (Its code is its own: written as one with the
//     resident tier's, it ran slower on an H100.) An unblocked step would
//     move the whole trailing submatrix through HBM (~89 MB a lane at
//     n = 256, more than L2 holds across the resident lanes); a panel
//     step moves it once per b columns. Each panel:
//       1. its columns, rows k0.., are staged into shared memory and
//          factored there;
//       2. the panel goes back by position, and the panel's row order
//          is applied to the columns left of it (through a shared stash
//          of the moved rows);
//       3. the columns right of it, in chunks of c: the moved rows are
//          stashed, the U rows formed in the stash, and the trailing rows
//          updated in register tiles as in the resident tier.
//     The first panel reads the input out of place (its trailing rows
//     through the position map), so nothing copies A first. b (32 down
//     to 1) and c (64, 32, 16) are the shape that keeps the most lanes on
//     an SM (b = 16 at n = 512). factor_solve then substitutes in warp 0,
//     with y in shared memory and the factors in device memory.
//   lu_solve off the warp tier is a tiled substitution, one block per
//   lane (see lu_solve_kernel): the factors stream in coalesced 32 x 32
//   tiles through each warp's own shared tile, each diagonal tile is
//   solved by shuffles, each off-diagonal one applied by the warp that
//   owns its rows, one block barrier per tile column and pass. The lane
//   takes the most warps (up to one per tile row, 8) with which every
//   lane is resident at once, else one: the solve is latency-bound, so
//   where lanes come in waves, lanes in flight beat warps per lane
//   (n = 165 and 256 at 2,048 lanes take one warp, n = 512 at 256 lanes
//   eight).
//   The right-hand sides [n, nrhs] stay in shared memory on every tier
//   but the warp tier: lu_solve needs n*nrhs*sizeof(T) bytes (a tile of
//   33*32 elements a warp beside them where they leave room; the threads
//   read the factors from device memory where they leave none), a
//   resident factor_solve its matrix beside them and a panel-tier
//   factor_solve n*nrhs*sizeof(T) + 4n (the panel's working set is reused
//   for them), within the opt-in limit (227 KB on an H100, e.g. nrhs <= 56
//   at n = 512 in float64, 112 in float32); a larger launch is refused
//   with a CUDA error, which the wrappers raise. Every budget is in bytes
//   of the type, the tier boundary too (see resident_threads).
//   The sweep's solves take nrhs = 1.

#include <cuda_runtime.h>

namespace {

// The update a - f * u, rounded as a separate multiply and subtract (no
// FMA contraction), in the element type.
__device__ __forceinline__ double upd(double a, double f, double u) {
  return __dsub_rn(a, __dmul_rn(f, u));
}
__device__ __forceinline__ float upd(float a, float f, float u) {
  return __fsub_rn(a, __fmul_rn(f, u));
}

// The lane's dynamic shared memory as an array of T (16-byte aligned).
template <typename T>
__device__ __forceinline__ T* dynamic_smem() {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  return reinterpret_cast<T*>(smem_bytes);
}

// 16-byte loads and stores: two doubles or four floats.
__device__ __forceinline__ void store16(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
__device__ __forceinline__ void store16(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void load16(const double* p, double (&v)[2]) {
  const double2 u = *reinterpret_cast<const double2*>(p);
  v[0] = u.x;
  v[1] = u.y;
}
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x;
  v[1] = u.y;
  v[2] = u.z;
  v[3] = u.w;
}

// Whether x is a number (not NaN), tested on x itself. (A test of fabs(x)
// against 0, such as fabs(x) >= 0, held for a NaN float on an H100 in
// this build, so a NaN pivot candidate won the search and an all-NaN
// column ran off the positions; a double was not affected.)
template <typename T>
__device__ __forceinline__ bool nan_free(T x) {
  return x == x;
}

// The first (for a double the high) 32-bit word of a non-negative value:
// non-negative floats order as their bit patterns, doubles as their (high
// word, low word) pairs.
__device__ __forceinline__ int pivot_word(double v) {
  return __double2hiint(v);
}
__device__ __forceinline__ int pivot_word(float v) { return __float_as_int(v); }

constexpr unsigned kFullWarp = 0xffffffffu;

// Substitution by one group of NP threads (a warp, or a half-warp with
// NP = 16: the shuffles are taken by the whole warp) over the unknowns at
// positions 0 .. m-1 (m <= NP, the same across the warp). The thread holds
// y at position `pos`; `row(i)` is its row's factor entry in column i (L
// left of the diagonal, U on and right of it) and `src(i)` the thread of
// the group that holds position i. Each finished unknown is broadcast by
// a shuffle: forward, y takes its updates in ascending i; backward, in
// descending i, and is divided after its last one.
template <int NP, typename T, typename Row, typename Src>
__device__ __forceinline__ T warp_forward(T y, int pos, int m, Row row,
                                          Src src) {
#pragma unroll
  for (int i = 0; i < NP - 1; ++i) {
    if (i + 1 < m) {
      const T yi = __shfl_sync(kFullWarp, y, src(i), NP);
      if (pos > i) y = upd(y, row(i), yi);
    }
  }
  return y;
}

template <int NP, typename T, typename Row, typename Src>
__device__ __forceinline__ T warp_backward(T y, int pos, int m, Row row,
                                           Src src) {
#pragma unroll
  for (int i = NP - 1; i >= 0; --i) {
    if (i < m) {
      if (pos == i) y = y / row(i);
      const T yi = __shfl_sync(kFullWarp, y, src(i), NP);
      if (pos < i) y = upd(y, row(i), yi);
    }
  }
  return y;
}

// ---------------------------------------------------------------------
// Warp tier: n == NP (16 or 32), one group of NP threads per lane.

constexpr int kWarpTierThreads = 128;

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

// What a warp-tier launch does with each lane's NP x NP block: factor it
// (LU, perm out), factor and solve it (b in, x out; the factors never
// leave registers), or solve with it as factors (LU and perm in, b in,
// x out).
enum WarpJob { kFactorJob, kFactorSolveJob, kSolveJob };

// Rows are never exchanged: thread r keeps row r and its position `pos`
// in the pivoted order. Step k swaps the positions of the pivot row and
// the row at position k, and every row at a position past k takes the
// update -- the operations the exchanging algorithm applies to each row,
// in the same order, so LU and perm come out bit for bit the same. The
// factors of kSolveJob are in position order: row r at position r.
template <typename T, int NP, int kJob>
__device__ __forceinline__ void lu_warp(const T* __restrict__ A,
                                        T* __restrict__ LU,
                                        int* __restrict__ perm,
                                        const T* __restrict__ b,
                                        T* __restrict__ x, long long lanes,
                                        int nrhs) {
  constexpr int n = NP;
  constexpr int LD = NP + 1;  // odd tile stride: row reads hit distinct banks
  constexpr int V = 16 / static_cast<int>(sizeof(T));  // per 16-byte load
  T* smem = dynamic_smem<T>();
  const int g = threadIdx.x / NP;
  const int r = threadIdx.x % NP;  // the row this thread keeps
  const long long first =
      static_cast<long long>(blockIdx.x) * (kWarpTierThreads / NP);
  // The last block's spare warps return; a spare half-warp group still
  // takes part in its warp's collectives but touches no memory.
  if (first + (threadIdx.x & ~31) / NP >= lanes) return;
  const long long lane = first + g;
  const bool live = lane < lanes;
  T* tile = smem + g * NP * LD;
  constexpr long long nn = static_cast<long long>(n) * n;

  // Stage the lane's contiguous block row by row (coalesced) through the
  // tile, every load in flight at once, then each thread takes its own
  // row into registers.
  if (live) {
    const T* src = A + lane * nn;
#pragma unroll
    for (int i = 0; i < n; ++i) tile[i * LD + r] = src[i * n + r];
  }
  __syncwarp();
  T a[NP];
#pragma unroll
  for (int j = 0; j < n; ++j) a[j] = live ? tile[r * LD + j] : T(0);
  __syncwarp();

  // From here the tile holds the pivot row, double-buffered by the parity
  // of the step, so one __syncwarp a step orders its write before the
  // reads of the same step and after the reads two steps back.
  int pos = r;
  if constexpr (kJob != kSolveJob) {
#pragma unroll
    for (int k = 0; k < n - 1; ++k) {
      // Pivot: max |a_rk| over the rows at positions k..n-1, the first
      // position on a tie; NaN is no candidate. A max-reduction of the
      // values' first words (pivot_word) decides unless they tie; a
      // double's low words then decide among the tied. The tie branches
      // are taken by the whole warp when either of its groups needs
      // them. Non-candidates take -2 and the row at position k -1 (so an
      // all-NaN column keeps it).
      const T v = fabs(a[k]);
      const bool cand = pos >= k && nan_free(a[k]);
      const int hi = cand ? pivot_word(v) : (pos == k ? -1 : -2);
      const int max_hi = group_max<NP>(hi, -2);  // (never short-circuited)
      bool top = hi == max_hi;
      unsigned hit = group_ballot<NP>(top);
      if (warp_any<NP>(hit & (hit - 1))) {
        if constexpr (sizeof(T) == 8) {
          const unsigned lo =
              top ? static_cast<unsigned>(__double2loint(v)) : 0u;
          const unsigned max_lo = group_max<NP>(lo, 0u);
          top = top && lo == max_lo;
          hit = group_ballot<NP>(top);
        }
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
      T* pb = tile + (k & 1) * NP;
      if (r == q) {
#pragma unroll
        for (int j = k & ~(V - 1); j < NP; j += V) {
          T w[V];
#pragma unroll
          for (int t = 0; t < V; ++t) w[t] = a[j + t];
          store16(pb + j, w);
        }
      }
      __syncwarp();
      if (pos > k) {
        const T f = a[k] / pb[k];
        a[k] = f;
#pragma unroll
        for (int j = (k + 1) & ~(V - 1); j < NP; j += V) {
          T u[V];
          load16(pb + j, u);
#pragma unroll
          for (int t = 0; t < V; ++t)
            if (j + t > k) a[j + t] = upd(a[j + t], f, u[t]);
        }
      }
    }
  }

  if constexpr (kJob == kFactorJob) {
    __syncwarp();  // the last step's pivot row is read; reuse the tile
#pragma unroll
    for (int j = 0; j < n; ++j) tile[pos * LD + j] = a[j];
    __syncwarp();
    if (live) {
      T* dst = LU + lane * nn;
#pragma unroll
      for (int i = 0; i < n; ++i) dst[i * n + r] = tile[i * LD + r];
      perm[lane * n + pos] = r;
    }
  } else {
    // Thread r holds y at its row's position: b[r] to begin with when it
    // factored (b[perm] in pivoted order), b[perm[r]] when it was given
    // the factors. Each finished unknown comes from the thread at its
    // position (at[i], the inverse permutation, gathered once through the
    // tile after a factorization).
    int at[NP];
    int b_row = r;
    if constexpr (kJob == kFactorSolveJob) {
      int* inv = reinterpret_cast<int*>(tile + 2 * NP);
      inv[pos] = r;
      __syncwarp();
#pragma unroll
      for (int i = 0; i < n; ++i) at[i] = inv[i];
    } else {
#pragma unroll
      for (int i = 0; i < n; ++i) at[i] = i;
      if (live) b_row = perm[lane * n + r];
    }
    const auto row = [&](int i) { return a[i]; };
    const auto src = [&](int i) { return at[i]; };
    const long long nk = static_cast<long long>(n) * nrhs;
    for (int c = 0; c < nrhs; ++c) {
      T y = live ? b[lane * nk + static_cast<long long>(b_row) * nrhs + c]
                 : T(0);
      y = warp_forward<NP>(y, pos, n, row, src);
      y = warp_backward<NP>(y, pos, n, row, src);
      if (live) x[lane * nk + static_cast<long long>(pos) * nrhs + c] = y;
    }
  }
}

template <typename T, int NP, int kJob>
__global__ void __launch_bounds__(kWarpTierThreads)
lu_warp_kernel(const T* __restrict__ A, T* __restrict__ LU,
               int* __restrict__ perm, const T* __restrict__ b,
               T* __restrict__ x, long long lanes, int nrhs) {
  lu_warp<T, NP, kJob>(A, LU, perm, b, x, lanes, nrhs);
}

// lu_factor at n = 32 (the ABI flagship's direction solves): at most 102
// registers a thread, so five blocks share an SM (a few spilled values
// cost less than the lost occupancy, on an H100).
template <typename T>
__global__ void __launch_bounds__(kWarpTierThreads, 5)
lu_factor_warp32_kernel(const T* __restrict__ A, T* __restrict__ LU,
                        int* __restrict__ perm, long long lanes) {
  lu_warp<T, 32, kFactorJob>(A, LU, perm, nullptr, nullptr, lanes, 0);
}

// ---------------------------------------------------------------------
// Resident and panel tiers: one block per lane, rows owned by threads
// and never exchanged.

constexpr int kPanelThreads = 256;
constexpr int kPanelWarps = kPanelThreads / 32;
constexpr int kPanelB = 32;  // panel width

// Row stride of a matrix resident in shared memory: odd, so the entries
// of one column fall on distinct banks (bank pairs for a double).
__host__ __device__ inline int smem_ld(int n) { return n | 1; }

// dst(e, j) = src(e, j) for e < rows, j < w: the threads over the
// flattened block (consecutive threads on consecutive columns), four
// loads in flight each.
template <typename T, int kThreads = kPanelThreads, typename Src,
          typename Dst>
__device__ __forceinline__ void copy_block(int rows, int w, Src src,
                                           Dst dst) {
  const int total = rows * w;
  for (int base = threadIdx.x; base < total; base += 4 * kThreads) {
    T v[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = base + t * kThreads;
      if (i < total) v[t] = src(i / w, i % w);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int i = base + t * kThreads;
      if (i < total) dst(i / w, i % w) = v[t];
    }
  }
}

// Whether pivot candidate (key, at) beats (best, best_at): the larger
// key, the smaller position on a tie. `at` packs a candidate's position
// (high 16 bits) and row (low 16: the tiers' shared memory keeps n
// below 12,000).
template <typename T>
__device__ __forceinline__ bool pivot_beats(T key, int at, T best,
                                            int best_at) {
  return key > best || (key == best && at < best_at);
}

// y = b[p] for one lane (shared memory), then a barrier.
template <typename T>
__device__ void gather_rhs(const T* bl, const int* p, T* y, int n,
                           int nrhs) {
  for (int e = threadIdx.x; e < n * nrhs; e += blockDim.x) {
    const int r = e / nrhs;
    const int c = e % nrhs;
    y[e] = bl[p[r] * nrhs + c];
  }
  __syncthreads();
}

// Solve (LU) x = y in place for one lane, warp 0 alone (no block
// barriers; the other warps return): `row(j)` points at the factors' row
// at position j, y [n, nrhs] is in shared memory. Each entry takes its
// updates in the order of warp_forward / warp_backward.
template <typename T, typename Row>
__device__ void solve_lane_warp(Row row, T* y, int n, int nrhs) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  for (int c = 0; c < nrhs; ++c) {
    for (int i = 0; i < n - 1; ++i) {
      const T yi = y[i * nrhs + c];
      for (int j = i + 1 + lane; j < n; j += 32)
        y[j * nrhs + c] = upd(y[j * nrhs + c], row(j)[i], yi);
      __syncwarp();
    }
    for (int i = n - 1; i >= 0; --i) {
      if (lane == 0) y[i * nrhs + c] = y[i * nrhs + c] / row(i)[i];
      __syncwarp();
      const T yi = y[i * nrhs + c];
      for (int j = lane; j < i; j += 32)
        y[j * nrhs + c] = upd(y[j * nrhs + c], row(j)[i], yi);
      __syncwarp();
    }
  }
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
// Resident tier: one block per lane, the matrix in shared memory.

// Steps k = 0 .. steps-1 of the panel at columns k0 .. k0+bw-1 of the
// lane's matrix `a` (row stride ld): thread t owns rows t, t + kThreads,
// ...; pos[r] is row r's position (rows at positions below k0 are
// pivoted). The pivot of column k0 + k is the maximum |a| over positions
// k0 + k .. (the first position on a tie): a (|a|, position)
// max-reduction by shuffles in each warp, then across warps through a
// double-buffered shared slot. NaN is no candidate: non-candidates key
// -2, the row at position k0 + k -1 (an all-NaN column keeps it). Each
// thread then divides and updates the panel columns of its own rows,
// which only it reads, so one barrier a step orders the updates before
// the next search. Ends without a barrier.
template <int kThreads, typename T>
__device__ __forceinline__ void resident_steps(T* a, int ld, int* pos,
                                               int n, int k0, int bw,
                                               int steps) {
  constexpr int kWarps = kThreads / 32;
  __shared__ T red_key[2][kWarps];
  __shared__ int red_at[2][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  T* P = a + k0;
  for (int k = 0; k < steps; ++k) {
    T best = T(-3);
    int best_at = n << 16;
    for (int r = tid; r < n; r += kThreads) {
      const int p = pos[r] - k0;
      if (p < k) continue;
      const T x = P[r * ld + k];
      const T key = nan_free(x) ? fabs(x) : (p == k ? T(-1) : T(-2));
      if (pivot_beats(key, p << 16 | r, best, best_at)) {
        best = key;
        best_at = p << 16 | r;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const T o_key = __shfl_xor_sync(kFullWarp, best, off, 32);
      const int o_at = __shfl_xor_sync(kFullWarp, best_at, off, 32);
      if (pivot_beats(o_key, o_at, best, best_at)) {
        best = o_key;
        best_at = o_at;
      }
    }
    const int s = k & 1;
    if (lane == 0) {
      red_key[s][warp] = best;
      red_at[s][warp] = best_at;
    }
    __syncthreads();
    best = red_key[s][0];
    best_at = red_at[s][0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      if (pivot_beats(red_key[s][w], red_at[s][w], best, best_at)) {
        best = red_key[s][w];
        best_at = red_at[s][w];
      }
    }
    const int best_pos = best_at >> 16;
    const int best_row = best_at & 0xffff;
    const T* u = P + best_row * ld;
    const T pivot = u[k];
    for (int r = tid; r < n; r += kThreads) {
      int p = pos[r] - k0;
      if (p == k) p = best_pos;
      if (r == best_row) p = k;
      pos[r] = p + k0;
      if (p <= k) continue;
      T* row = P + r * ld;
      const T f = row[k] / pivot;
      row[k] = f;
      for (int j0 = k + 1; j0 < bw; j0 += 8) {  // eight loads in flight
        T v[8], uj[8];
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
}

// The U rows of the panel at columns k0 .. k0+bw-1 (the rows at
// positions k0 .., at[] holding them) in columns c0 .. c0+w-1, each entry
// taking the panel's updates in ascending k against the unit-lower panel.
// A warp per 8 columns, lane r on the row at position k0 + r.
template <int kThreads, typename T>
__device__ __forceinline__ void resident_u_rows(T* a, int ld, const int* at,
                                                int k0, int bw, int c0,
                                                int w) {
  constexpr int kWarps = kThreads / 32;
  const int r = threadIdx.x & 31;
  const bool live = r < bw;
  T* row = a + at[k0 + (live ? r : 0)] * ld;
  const T* l = row + k0;
  for (int g = (threadIdx.x >> 5) * 8; g < w; g += kWarps * 8) {
    T v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t)
      v[t] = live && g + t < w ? row[c0 + g + t] : T(0);
    for (int q = 0; q + 1 < bw; ++q) {
      const T lq = l[q];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const T uq = __shfl_sync(kFullWarp, v[t], q);
        if (r > q && live) v[t] = upd(v[t], lq, uq);
      }
    }
#pragma unroll
    for (int t = 0; t < 8; ++t)
      if (live && g + t < w) row[c0 + g + t] = v[t];
  }
}

// The trailing rows (positions c0 .. c0+w-1) in columns c0 .. c0+w-1,
// each entry taking the panel's bw updates in ascending k. Each warp
// takes 16 x 32 tiles, each thread a 4 x 4 tile (rows 4 apart, columns 8
// apart) loaded once, updated in registers and written once.
template <int kThreads, typename T>
__device__ __forceinline__ void resident_trailing(T* a, int ld,
                                                  const int* at, int k0,
                                                  int bw, int c0, int w) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int rg = lane >> 3;
  const int cl = lane & 7;
  const int col_tiles = (w + 31) / 32;
  const int tiles = (w + 15) / 16 * col_tiles;
  for (int t = threadIdx.x >> 5; t < tiles; t += kWarps) {
    const int ib = t / col_tiles * 16 + rg;
    const int j0 = t % col_tiles * 32 + cl;
    T* row[4];
    bool row_ok[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      row_ok[p] = ib + 4 * p < w;
      row[p] = a + at[c0 + (row_ok[p] ? ib + 4 * p : 0)] * ld;
    }
    int col[4];
    bool col_ok[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      col_ok[q] = j0 + 8 * q < w;
      col[q] = c0 + (col_ok[q] ? j0 + 8 * q : w - 1);
    }
    T acc[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = row[p][col[q]];
#pragma unroll 4
    for (int k = 0; k < bw; ++k) {
      const T* uk = a + at[k0 + k] * ld;
      T l[4], u[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) l[p] = row[p][k0 + k];
#pragma unroll
      for (int q = 0; q < 4; ++q) u[q] = uk[col[q]];
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = upd(acc[p][q], l[p], u[q]);
    }
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (row_ok[p] && col_ok[q]) row[p][col[q]] = acc[p][q];
  }
}

// Partial-pivoted LU of one lane's [n, n] matrix `a` (row stride `ld`,
// shared memory), right-looking, kPanelB columns at a time, rows never
// exchanged. Each panel: its steps (resident_steps); the map at[position]
// = row; the U rows right of the panel and the trailing rows in register
// tiles. On return pos [n] holds each row's position and at [n] the row
// at each position (the permutation); ends with a barrier. The barrier
// after the first initialization also orders the caller's copy of `a`.
template <int kThreads, typename T>
__device__ void factor_resident(T* a, int ld, int n, int* pos, int* at) {
  for (int r = threadIdx.x; r < n; r += kThreads) pos[r] = at[r] = r;
  __syncthreads();
  for (int k0 = 0; k0 < n - 1; k0 += kPanelB) {
    const int bw = min(kPanelB, n - k0);
    resident_steps<kThreads>(a, ld, pos, n, k0, bw, min(bw, n - 1 - k0));
    __syncthreads();
    for (int r = threadIdx.x; r < n; r += kThreads)
      if (pos[r] >= k0) at[pos[r]] = r;
    __syncthreads();
    const int c0 = k0 + bw;
    if (c0 == n) break;
    resident_u_rows<kThreads>(a, ld, at, k0, bw, c0, n - c0);
    __syncthreads();
    resident_trailing<kThreads>(a, ld, at, k0, bw, c0, n - c0);
    __syncthreads();
  }
}

// Shared memory of the resident tier in bytes (nrhs = 0 for lu_factor):
// the matrix, the right-hand sides, each row's position and the row at
// each position.
template <typename T>
long long resident_smem(int n, int nrhs) {
  return (static_cast<long long>(n) * smem_ld(n) +
          static_cast<long long>(n) * nrhs) * sizeof(T) + 8LL * n;
}

// Six 128-thread lanes an SM (n = 64) must fit its registers.
constexpr int resident_min_blocks(int threads) {
  return threads == 128 ? 6 : 2;
}

template <typename T, int kThreads>
__global__ void __launch_bounds__(kThreads, resident_min_blocks(kThreads))
lu_factor_kernel(const T* __restrict__ A, T* __restrict__ LU,
                 int* __restrict__ perm, int n) {
  T* smem = dynamic_smem<T>();
  const long long lane = blockIdx.x;
  const long long nn = static_cast<long long>(n) * n;
  const int ld = smem_ld(n);
  int* pos = reinterpret_cast<int*>(smem + n * ld);
  int* at = pos + n;
  const T* src = A + lane * nn;
  copy_block<T, kThreads>(
      n, n, [&](int i, int j) { return src[i * n + j]; },
      [&](int i, int j) -> T& { return smem[i * ld + j]; });
  factor_resident<kThreads>(smem, ld, n, pos, at);
  T* dst = LU + lane * nn;  // by position
  copy_block<T, kThreads>(
      n, n, [&](int p, int j) { return smem[at[p] * ld + j]; },
      [&](int p, int j) -> T& { return dst[p * n + j]; });
  for (int p = threadIdx.x; p < n; p += kThreads) perm[lane * n + p] = at[p];
}

template <typename T, int kThreads>
__global__ void __launch_bounds__(kThreads, resident_min_blocks(kThreads))
factor_solve_kernel(const T* __restrict__ A, const T* __restrict__ b,
                    T* __restrict__ x, int n, int nrhs) {
  T* smem = dynamic_smem<T>();
  const long long lane = blockIdx.x;
  const long long nn = static_cast<long long>(n) * n;
  const long long nk = static_cast<long long>(n) * nrhs;
  const int ld = smem_ld(n);
  T* y = smem + n * ld;
  int* pos = reinterpret_cast<int*>(y + n * nrhs);
  int* at = pos + n;
  const T* src = A + lane * nn;
  copy_block<T, kThreads>(
      n, n, [&](int i, int j) { return src[i * n + j]; },
      [&](int i, int j) -> T& { return smem[i * ld + j]; });
  factor_resident<kThreads>(smem, ld, n, pos, at);
  gather_rhs(b + lane * nk, at, y, n, nrhs);
  solve_lane_warp([&](int j) { return smem + at[j] * ld; }, y, n, nrhs);
  if (threadIdx.x >= 32) return;
  T* xl = x + lane * nk;
  for (int e = threadIdx.x; e < n * nrhs; e += 32) xl[e] = y[e];
}

// ---------------------------------------------------------------------
// Panel tier: one block per lane, the matrix in device memory.

constexpr int kPanelC = 64;  // column chunk of the trailing update

// Shared memory of the panel tier in bytes, the permutation left out:
// the panel (n rows at the odd stride b | 1), the stash of up to 2b
// moved rows by c columns (stride c + 1), each row's position and the
// row at each position, the moved positions and their permutation
// entries.
template <typename T>
long long panel_work_bytes(int n, int b, int c) {
  return static_cast<long long>(sizeof(T)) *
             (static_cast<long long>(n) * (b | 1) + 2LL * b * (c + 1)) +
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
// chunk. (At n = 512 a panel of 16 lets two double lanes share an SM
// where a panel of 32 leaves one; each lane's stretches of pivot searches
// and barriers then overlap the other's trailing updates.)
template <typename T, typename K>
PanelPlan panel_plan(K kernel, int n, int nrhs, long long limit) {
  PanelPlan plan;
  int most = 0;
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return plan;
  const long long room = limit - static_cast<long long>(attr.sharedSizeBytes);
  if (reserve_smem(kernel, static_cast<size_t>(room)) != cudaSuccess)
    return plan;
  const long long rhs = static_cast<long long>(sizeof(T)) * n * nrhs;
  for (int b = kPanelB; b >= 1; b >>= 1) {
    for (int c = kPanelC; c >= 16; c >>= 1) {
      const long long work = panel_work_bytes<T>(n, b, c);
      const long long off = work > rhs ? work : rhs;
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


// U rows of one column chunk: the stash rows 0..bw-1 of its w columns
// (the panel's row order already applied) against the unit-lower panel,
// each entry's updates in ascending k. A warp per 8 columns, lane r on
// row r; the result goes to the stash and to `a` (rows k0 .., columns
// c0 ..).
template <typename T>
__device__ void panel_u_rows(const T* P, int ldp, const int* at, T* S,
                             int lds, T* a, int n, int k0, int bw, int c0,
                             int w) {
  const int r = threadIdx.x & 31;
  const bool live = r < bw;
  const T* l = P + (live ? at[r] : 0) * ldp;
  for (int g = (threadIdx.x >> 5) * 8; g < w; g += kPanelWarps * 8) {
    T v[8];
#pragma unroll
    for (int t = 0; t < 8; ++t)
      v[t] = live && g + t < w ? S[r * lds + g + t] : T(0);
    for (int q = 0; q + 1 < bw; ++q) {
      const T lq = l[q];
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const T uq = __shfl_sync(kFullWarp, v[t], q);
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
template <typename T>
__device__ void panel_trailing(const T* P, int ldp, const int* at,
                               const T* S, int lds, const T* from,
                               bool remap, T* a, int n, int k0, int bw,
                               int m, int c0, int w) {
  const int lane = threadIdx.x & 31;
  const int rg = lane >> 3;
  const int cl = lane & 7;
  const int col_tiles = (w + 31) / 32;
  const int tiles = (m - bw + 15) / 16 * col_tiles;
  for (int t = threadIdx.x >> 5; t < tiles; t += kPanelWarps) {
    const int i0 = bw + t / col_tiles * 16 + rg;
    const int j0 = t % col_tiles * 32 + cl;
    const T* lrow[4];
    const T* in[4];
    T* out[4];
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
    T acc[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = in[p][col[q]];
#pragma unroll 4
    for (int k = 0; k < bw; ++k) {
      T l[4], u[4];
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
// `smem` holds panel_work_bytes<T>(n, b, c). Ends with a barrier.
template <typename T>
__device__ void factor_panels(const T* __restrict__ in, T* a, int n, int b,
                              int c, T* smem, int* perm) {
  __shared__ T red_key[2][kPanelWarps];
  __shared__ int red_at[2][kPanelWarps];
  __shared__ int s_moved;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ldp = b | 1;
  const int lds = c + 1;
  T* P = smem;
  T* S = P + n * ldp;
  int* pos = reinterpret_cast<int*>(S + 2 * b * lds);  // of each panel row
  int* at = pos + n;                                   // row at a position
  int* moved = at + n;  // positions 0..bw-1, then the others that moved
  int* moved_perm = moved + 2 * b;
  for (int i = tid; i < n; i += kPanelThreads) perm[i] = i;
  for (int k0 = 0; k0 < max(n - 1, 1); k0 += b) {
    const int m = n - k0;
    const int bw = min(b, m);
    const T* from = k0 == 0 ? in : a;

    // 1. Stage the panel and factor it in shared memory. Thread t owns
    // rows t, t + 256, ...; rows are never exchanged, pos[r] is row r's
    // position in the pivoted order.
    copy_block<T>(
        m, bw, [&](int r, int j) { return from[(k0 + r) * n + k0 + j]; },
        [&](int r, int j) -> T& { return P[r * ldp + j]; });
    for (int r = tid; r < m; r += kPanelThreads) pos[r] = r;
    __syncthreads();
    for (int k = 0; k < min(bw, m - 1); ++k) {
      // Pivot: max |a| over positions k.., the first position on a tie.
      // NaN is no candidate: non-candidates key -2, the row at position
      // k -1 (an all-NaN column keeps it). Each thread reads only its
      // own rows, which it updated itself, so one barrier a step orders
      // the updates before the reads of the next pivot row.
      T best = T(-3);
      int best_at = m << 16;
      for (int r = tid; r < m; r += kPanelThreads) {
        const int p = pos[r];
        if (p < k) continue;
        const T x = P[r * ldp + k];
        const T key = nan_free(x) ? fabs(x) : (p == k ? T(-1) : T(-2));
        if (pivot_beats(key, p << 16 | r, best, best_at)) {
          best = key;
          best_at = p << 16 | r;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const T o_key = __shfl_xor_sync(kFullWarp, best, off, 32);
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
      const T* u = P + best_row * ldp;
      const T pivot = u[k];
      for (int r = tid; r < m; r += kPanelThreads) {
        int p = pos[r];
        if (p == k) p = best_pos;
        if (r == best_row) p = k;
        pos[r] = p;
        if (p <= k) continue;
        T* row = P + r * ldp;
        const T f = row[k] / pivot;
        row[k] = f;
        for (int j0 = k + 1; j0 < bw; j0 += 8) {  // eight loads in flight
          T v[8], uj[8];
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
    copy_block<T>(
        m, bw, [&](int r, int j) { return P[r * ldp + j]; },
        [&](int r, int j) -> T& { return a[(k0 + pos[r]) * n + k0 + j]; });
    __syncthreads();
    const int n_moved = s_moved;
    for (int e = tid; e < n_moved; e += kPanelThreads)
      moved_perm[e] = perm[k0 + at[moved[e]]];
    __syncthreads();
    for (int e = tid; e < n_moved; e += kPanelThreads)
      perm[k0 + moved[e]] = moved_perm[e];

    // 3. The panel's row order on the columns left of it: the moved rows
    // through the stash.
    auto stash = [&](int e, int j) -> T& { return S[e * lds + j]; };
    for (int c0 = 0; c0 < k0; c0 += c) {
      const int w = min(c, k0 - c0);
      copy_block<T>(
          n_moved, w,
          [&](int e, int j) { return a[(k0 + at[moved[e]]) * n + c0 + j]; },
          stash);
      __syncthreads();
      copy_block<T>(
          n_moved, w, stash,
          [&](int e, int j) -> T& { return a[(k0 + moved[e]) * n + c0 + j]; });
      __syncthreads();
    }

    // 4. The columns right of it, chunk by chunk: the U rows (and, in
    // place, the other moved rows) through the stash, then the trailing
    // update.
    for (int c0 = k0 + bw; c0 < n; c0 += c) {
      const int w = min(c, n - c0);
      copy_block<T>(
          k0 == 0 ? bw : n_moved, w,
          [&](int e, int j) { return from[(k0 + at[moved[e]]) * n + c0 + j]; },
          stash);
      __syncthreads();
      if (k0 > 0) {
        copy_block<T>(
            n_moved - bw, w,
            [&](int e, int j) { return S[(bw + e) * lds + j]; },
            [&](int e, int j) -> T& {
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

template <typename T>
__global__ void __launch_bounds__(kPanelThreads, 2)
lu_factor_panel_kernel(const T* __restrict__ A, T* __restrict__ LU,
                       int* __restrict__ perm, int n, int b, int c,
                       long long perm_off) {
  T* smem = dynamic_smem<T>();
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
template <typename T>
__global__ void __launch_bounds__(kPanelThreads, 2)
factor_solve_panel_kernel(const T* __restrict__ A, const T* __restrict__ b,
                          T* __restrict__ x, T* __restrict__ work, int n,
                          int nrhs, int pb, int c, long long perm_off) {
  T* smem = dynamic_smem<T>();
  const long long lane = blockIdx.x;
  const long long nn = static_cast<long long>(n) * n;
  const long long nk = static_cast<long long>(n) * nrhs;
  int* p = reinterpret_cast<int*>(reinterpret_cast<char*>(smem) + perm_off);
  T* a = work + lane * nn;
  factor_panels(A + lane * nn, a, n, pb, c, smem, p);
  gather_rhs(b + lane * nk, p, smem, n, nrhs);
  solve_lane_warp([&](int j) { return a + j * n; }, smem, n, nrhs);
  if (threadIdx.x >= 32) return;
  T* xl = x + lane * nk;
  for (int e = threadIdx.x; e < n * nrhs; e += 32) xl[e] = smem[e];
}

// ---------------------------------------------------------------------
// lu_solve off the warp tier: a tiled substitution, one block per lane.
//
// The factors go through 32 x 32 tiles; tile row I (rows 32I ..) is warp
// I % nw's, and each thread of that warp owns one row of it. Forward
// step J (J = 0 .. T-1): the owner of tile row J solves the diagonal
// tile's unit-lower triangle with shuffles (warp_forward); one block
// barrier; each warp applies tile (I, J) to its rows I > J, each row's
// 32 updates in ascending i. Backward step J (T-1 .. 0): the diagonal
// tile's upper triangle (warp_backward), a barrier, tiles (I, J) of rows
// I < J in descending i. A row's updates from different tiles come in
// step order, so each entry of y takes exactly the order of
// warp_forward / warp_backward over all n unknowns. y [n, nrhs] stays in
// shared memory; each warp streams its own tiles through a private
// odd-stride tile (coalesced row loads, the next tile in registers while
// the current one is applied). Where y leaves no room for a tile, the
// threads read their rows from device memory instead (kStaged false).

constexpr int kTile = 32;
constexpr int kTileLd = kTile + 1;
constexpr int kTileElems = kTile * kTileLd;
constexpr int kSolveMaxWarps = 8;

// One tile a warp applies: at step s (s < T forward, else backward),
// tile row I; s == 2T once the warp has none left.
struct SolveTask {
  int s, I;
};

__device__ __forceinline__ int step_col(int s, int T) {
  return s < T ? s : 2 * T - 1 - s;
}

// The first of warp w's tile rows past J in the step's direction (may lie
// outside 0 .. T-1).
__device__ __forceinline__ int first_row_past(int J, bool fwd, int w,
                                              int nw) {
  return fwd ? J + 1 + ((w - J - 1) % nw + nw) % nw
             : J - 1 - ((J - 1 - w) % nw + nw) % nw;
}

// The tile warp w applies after `t`: at each step the diagonal tile if
// tile row J is the warp's, then its rows past J in the step's direction.
__device__ SolveTask next_task(SolveTask t, int w, int nw, int T) {
  int J = step_col(t.s, T);
  bool fwd = t.s < T;
  int I = t.I == J ? first_row_past(J, fwd, w, nw) : fwd ? t.I + nw
                                                         : t.I - nw;
  while (fwd ? I >= T : I < 0) {
    if (++t.s == 2 * T) break;
    J = step_col(t.s, T);
    fwd = t.s < T;
    I = J % nw == w ? J : first_row_past(J, fwd, w, nw);
  }
  t.I = I;
  return t;
}

// Tile (I, J) of one lane's factors into v: thread j of the warp takes
// column j of each of the tile's rows, so each row's load is coalesced;
// 0 outside the matrix.
template <typename T>
__device__ __forceinline__ void load_tile(const T* lu, int n, int I, int J,
                                          T (&v)[kTile]) {
  const int j = threadIdx.x & 31;
  const int rows = min(kTile, n - kTile * I);
  const bool col_ok = kTile * J + j < n;
  const T* p = lu + static_cast<long long>(kTile * I) * n + kTile * J + j;
#pragma unroll
  for (int q = 0; q < kTile; ++q)
    v[q] = col_ok && q < rows ? p[static_cast<long long>(q) * n] : T(0);
}

template <typename T, bool kStaged>
__global__ void __launch_bounds__(kSolveMaxWarps * 32, 2)
lu_solve_kernel(const T* __restrict__ LU, const int* __restrict__ perm,
                const T* __restrict__ b, T* __restrict__ x, int n,
                int nrhs) {
  T* smem = dynamic_smem<T>();
  const long long lane = blockIdx.x;
  const long long nk = static_cast<long long>(n) * nrhs;
  const int Tn = (n + kTile - 1) / kTile;
  const int nw = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int r = threadIdx.x & 31;
  const T* lu = LU + lane * static_cast<long long>(n) * n;
  T* y = smem;
  T* tile = smem + n * nrhs + w * kTileElems;
  SolveTask t = w == 0 ? SolveTask{0, 0} : next_task({0, 0}, w, nw, Tn);
  T v[kTile];
  if constexpr (kStaged) {
    if (t.s < 2 * Tn) load_tile(lu, n, t.I, step_col(t.s, Tn), v);
  }
  gather_rhs(b + lane * nk, perm + lane * n, y, n, nrhs);
  // This thread's row of the tile the warp applies next, tile (I, J):
  // staged, the tile in v lands in the warp's tile and the one after
  // goes into v.
  const auto take = [&](int I, int J) -> const T* {
    t = next_task(t, w, nw, Tn);
    if constexpr (kStaged) {
      __syncwarp();
#pragma unroll
      for (int q = 0; q < kTile; ++q) tile[q * kTileLd + r] = v[q];
      __syncwarp();
      if (t.s < 2 * Tn) load_tile(lu, n, t.I, step_col(t.s, Tn), v);
      return tile + r * kTileLd;
    } else {
      return lu + static_cast<long long>(min(kTile * I + r, n - 1)) * n +
             kTile * J;
    }
  };
  for (int s = 0; s < 2 * Tn; ++s) {
    const int J = step_col(s, Tn);
    const bool fwd = s < Tn;
    const int c0 = kTile * J;
    const int bw = min(kTile, n - c0);
    if (J % nw == w) {
      const T* row = take(J, J);
      const auto entry = [&](int i) { return row[i]; };
      const auto src = [](int i) { return i; };
      for (int c = 0; c < nrhs; ++c) {
        T* yr = y + (c0 + min(r, bw - 1)) * nrhs + c;
        T yv = *yr;
        yv = fwd ? warp_forward<kTile>(yv, r, bw, entry, src)
                 : warp_backward<kTile>(yv, r, bw, entry, src);
        if (r < bw) *yr = yv;
      }
    }
    if (s != Tn - 1) __syncthreads();  // forward step T-1 has no off-diagonal
    while (t.s == s) {
      const int r0 = kTile * t.I;
      const T* row = take(t.I, J);
      if (r0 + r < n) {
        for (int c = 0; c < nrhs; ++c) {
          T* yr = y + (r0 + r) * nrhs + c;
          const T* yj = y + c0 * nrhs + c;
          T acc = *yr;
          if (fwd) {
#pragma unroll 8
            for (int i = 0; i < bw; ++i) acc = upd(acc, row[i], yj[i * nrhs]);
          } else {
#pragma unroll 8
            for (int i = bw - 1; i >= 0; --i)
              acc = upd(acc, row[i], yj[i * nrhs]);
          }
          *yr = acc;
        }
      }
    }
  }
  T* xl = x + lane * nk;
  for (int e = threadIdx.x; e < n * nrhs; e += blockDim.x) xl[e] = y[e];
}


// ---------------------------------------------------------------------
// Launches and the choice of tier.

// The device's SM count and its per-SM shared memory, less what each
// block reserves; 0 when the device cannot be queried.
struct SmShape {
  long long sms = 0, smem = 0, reserved = 0;
};

SmShape sm_shape() {
  SmShape sh;
  int dev = 0, sms = 0, smem = 0, reserved = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaDeviceGetAttribute(&smem,
                             cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                             dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&reserved,
                             cudaDevAttrReservedSharedMemoryPerBlock,
                             dev) != cudaSuccess)
    return sh;
  sh.sms = sms;
  sh.smem = smem;
  sh.reserved = reserved;
  return sh;
}

// The kernel's static shared memory in bytes, or -1.
template <typename K>
long long static_smem(K kernel) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) return -1;
  return static_cast<long long>(attr.sharedSizeBytes);
}

// Threads a lane of the resident tier takes (`bytes` of dynamic shared
// memory), or 0 for the panel tier. The rule is a measured one (the
// header's table, H100, float64): the resident tier is faster while two
// or more lanes share an SM and slower with one (its pivot steps'
// latency then shows; the panel tier fits more lanes), and 128 threads
// are faster where three or more lanes fit (their registers then admit
// them all), 256 where two do. The rule counts each type's own bytes, so
// a float lane stays resident to a larger n (n <= 168 at k = 1 on an
// H100): measured faster than the panel tier there as well (H100 80GB
// HBM3 at 700 W, float32, ms resident / panel: n = 112 x 4,096 1.5695 /
// 2.5126, n = 128 x 4,096 2.2502 / 2.9524, n = 165 x 2,048 2.2002 /
// 2.6786; at n = 200, one lane an SM, 4.6548 / 3.7335: the rule holds).
// tools/tier_boundary.py times both tiers in both types.
template <typename K128, typename K256>
int resident_threads(K128 k128, K256 k256, long long bytes,
                     long long limit) {
  const long long fixed = static_smem(k256);
  if (fixed < 0 || static_smem(k128) < 0 || bytes + fixed > limit) return 0;
  const SmShape sh = sm_shape();
  const long long lanes = sh.smem / (bytes + fixed + sh.reserved);
  if (lanes >= 3) return 128;
  return lanes == 2 ? 256 : 0;
}

template <typename T>
int factor_threads(int n, long long limit) {
  return resident_threads(lu_factor_kernel<T, 128>, lu_factor_kernel<T, 256>,
                          resident_smem<T>(n, 0), limit);
}

template <typename T>
int factor_solve_threads(int n, int nrhs, long long limit) {
  return resident_threads(factor_solve_kernel<T, 128>,
                          factor_solve_kernel<T, 256>,
                          resident_smem<T>(n, nrhs), limit);
}

template <typename T>
cudaError_t launch_lu_factor(const T* A, T* LU, int* perm, long long lanes,
                             int n, int threads, cudaStream_t s) {
  const size_t bytes = static_cast<size_t>(resident_smem<T>(n, 0));
  const unsigned int grid = static_cast<unsigned int>(lanes);
  if (threads == 128) {
    cudaError_t err = reserve_smem(lu_factor_kernel<T, 128>, bytes);
    if (err != cudaSuccess) return err;
    lu_factor_kernel<T, 128><<<grid, 128, bytes, s>>>(A, LU, perm, n);
  } else {
    cudaError_t err = reserve_smem(lu_factor_kernel<T, 256>, bytes);
    if (err != cudaSuccess) return err;
    lu_factor_kernel<T, 256><<<grid, 256, bytes, s>>>(A, LU, perm, n);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_lu_factor_panel(const T* A, T* LU, int* perm,
                                   long long lanes, int n, long long limit,
                                   cudaStream_t s) {
  const PanelPlan plan =
      panel_plan<T>(lu_factor_panel_kernel<T>, n, 0, limit);
  if (plan.b == 0) return cudaErrorInvalidValue;
  lu_factor_panel_kernel<T><<<static_cast<unsigned int>(lanes),
                              kPanelThreads, plan.bytes, s>>>(
      A, LU, perm, n, plan.b, plan.c, plan.perm_off);
  return cudaGetLastError();
}

// Warps a lane of the tiled solve: the most (one per tile row, at most
// 8) with which every lane is resident at once, by the occupancy
// calculator; else one, which keeps the most lanes in flight (the lanes
// then come in waves, and each lane's steps are latency-bound). Each warp
// needs its tile beside y; 0 where not even one fits.
template <typename T>
int solve_warps(int n, int nrhs, long long lanes, long long limit) {
  const long long ybytes = static_cast<long long>(sizeof(T)) * n * nrhs;
  const long long tile_bytes = static_cast<long long>(sizeof(T)) * kTileElems;
  const int tile_rows = (n + kTile - 1) / kTile;
  const long long sms = sm_shape().sms;
  if (reserve_smem(lu_solve_kernel<T, true>, static_cast<size_t>(limit)) !=
      cudaSuccess)
    return 0;
  int fits = 0;
  for (int nw = tile_rows < kSolveMaxWarps ? tile_rows : kSolveMaxWarps;
       nw >= 1; --nw) {
    const long long bytes = ybytes + nw * tile_bytes;
    int blocks = 0;
    if (bytes > limit ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &blocks, lu_solve_kernel<T, true>, nw * 32,
            static_cast<size_t>(bytes)) != cudaSuccess)
      continue;
    fits = nw;
    if (blocks * sms >= lanes) return nw;
  }
  return fits;
}

// The warp tier at n == NP.
template <typename T, int NP, int kJob>
cudaError_t launch_warp(const T* A, T* LU, int* perm, const T* b, T* x,
                        long long lanes, int nrhs, cudaStream_t stream) {
  constexpr int per_block = kWarpTierThreads / NP;
  const size_t bytes = sizeof(T) * kWarpTierThreads * (NP + 1);
  const unsigned int grid =
      static_cast<unsigned int>((lanes + per_block - 1) / per_block);
  if constexpr (NP == 32 && kJob == kFactorJob) {
    cudaError_t err = reserve_smem(lu_factor_warp32_kernel<T>, bytes);
    if (err != cudaSuccess) return err;
    lu_factor_warp32_kernel<T><<<grid, kWarpTierThreads, bytes, stream>>>(
        A, LU, perm, lanes);
  } else {
    cudaError_t err = reserve_smem(lu_warp_kernel<T, NP, kJob>, bytes);
    if (err != cudaSuccess) return err;
    lu_warp_kernel<T, NP, kJob><<<grid, kWarpTierThreads, bytes, stream>>>(
        A, LU, perm, b, x, lanes, nrhs);
  }
  return cudaGetLastError();
}

// The entry points' bodies, for T = double and T = float.

template <typename T>
long long factor_solve_workspace(int n, int nrhs) {
  if (n == 16 || n == 32) return 0;
  return factor_solve_threads<T>(n, nrhs, smem_optin()) > 0
             ? 0
             : static_cast<long long>(n) * n;
}

template <typename T>
int lu_factor_entry(const T* A, T* LU, int* perm, long long lanes, int n,
                    void* stream) {
  if (n < 1 || lanes < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 16)
    return launch_warp<T, 16, kFactorJob>(A, LU, perm, nullptr, nullptr,
                                          lanes, 0, s);
  if (n == 32)
    return launch_warp<T, 32, kFactorJob>(A, LU, perm, nullptr, nullptr,
                                          lanes, 0, s);
  const long long limit = smem_optin();
  if (limit <= 0) return cudaErrorInvalidDevice;
  const int threads = factor_threads<T>(n, limit);
  if (threads > 0) return launch_lu_factor(A, LU, perm, lanes, n, threads, s);
  return launch_lu_factor_panel(A, LU, perm, lanes, n, limit, s);
}

template <typename T>
int lu_solve_entry(const T* LU, const int* perm, const T* b, T* x,
                   long long lanes, int n, int nrhs, void* stream) {
  if (n < 1 || nrhs < 1 || lanes < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* p = const_cast<int*>(perm);  // only read by kSolveJob
  if (n == 16)
    return launch_warp<T, 16, kSolveJob>(LU, nullptr, p, b, x, lanes, nrhs,
                                         s);
  if (n == 32)
    return launch_warp<T, 32, kSolveJob>(LU, nullptr, p, b, x, lanes, nrhs,
                                         s);
  const long long limit = smem_optin();
  if (limit <= 0) return cudaErrorInvalidDevice;
  const int nw = solve_warps<T>(n, nrhs, lanes, limit);
  const long long ybytes = static_cast<long long>(sizeof(T)) * n * nrhs;
  const unsigned int grid = static_cast<unsigned int>(lanes);
  if (nw > 0) {
    const size_t bytes = static_cast<size_t>(
        ybytes + static_cast<long long>(sizeof(T)) * nw * kTileElems);
    cudaError_t err = reserve_smem(lu_solve_kernel<T, true>, bytes);
    if (err != cudaSuccess) return err;
    lu_solve_kernel<T, true><<<grid, nw * 32, bytes, s>>>(LU, perm, b, x, n,
                                                          nrhs);
  } else {
    const size_t bytes = static_cast<size_t>(ybytes);
    cudaError_t err = reserve_smem(lu_solve_kernel<T, false>, bytes);
    if (err != cudaSuccess) return err;
    lu_solve_kernel<T, false><<<grid, 32, bytes, s>>>(LU, perm, b, x, n,
                                                      nrhs);
  }
  return cudaGetLastError();
}

template <typename T>
int factor_solve_entry(const T* A, const T* b, T* x, T* work,
                       long long lanes, int n, int nrhs, void* stream) {
  if (n < 1 || nrhs < 1 || lanes < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 16)
    return launch_warp<T, 16, kFactorSolveJob>(A, nullptr, nullptr, b, x,
                                               lanes, nrhs, s);
  if (n == 32)
    return launch_warp<T, 32, kFactorSolveJob>(A, nullptr, nullptr, b, x,
                                               lanes, nrhs, s);
  const long long limit = smem_optin();
  if (limit <= 0) return cudaErrorInvalidDevice;
  const int threads = factor_solve_threads<T>(n, nrhs, limit);
  const unsigned int grid = static_cast<unsigned int>(lanes);
  if (threads > 0) {
    const size_t bytes = static_cast<size_t>(resident_smem<T>(n, nrhs));
    if (threads == 128) {
      cudaError_t err = reserve_smem(factor_solve_kernel<T, 128>, bytes);
      if (err != cudaSuccess) return err;
      factor_solve_kernel<T, 128><<<grid, 128, bytes, s>>>(A, b, x, n, nrhs);
    } else {
      cudaError_t err = reserve_smem(factor_solve_kernel<T, 256>, bytes);
      if (err != cudaSuccess) return err;
      factor_solve_kernel<T, 256><<<grid, 256, bytes, s>>>(A, b, x, n, nrhs);
    }
    return cudaGetLastError();
  }
  if (work == nullptr) return cudaErrorInvalidValue;
  const PanelPlan plan =
      panel_plan<T>(factor_solve_panel_kernel<T>, n, nrhs, limit);
  if (plan.b == 0) return cudaErrorInvalidValue;
  factor_solve_panel_kernel<T><<<grid, kPanelThreads, plan.bytes, s>>>(
      A, b, x, work, n, nrhs, plan.b, plan.c, plan.perm_off);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Device workspace factor_solve needs, in elements per lane: n*n where
// the lane takes the panel tier, else 0.
long long pk_factor_solve_workspace(int n, int nrhs) {
  return factor_solve_workspace<double>(n, nrhs);
}
long long pk_factor_solve_workspace_f32(int n, int nrhs) {
  return factor_solve_workspace<float>(n, nrhs);
}

int pk_lu_factor(const double* A, double* LU, int* perm, long long lanes,
                 int n, void* stream) {
  return lu_factor_entry(A, LU, perm, lanes, n, stream);
}
int pk_lu_factor_f32(const float* A, float* LU, int* perm, long long lanes,
                     int n, void* stream) {
  return lu_factor_entry(A, LU, perm, lanes, n, stream);
}

int pk_lu_solve(const double* LU, const int* perm, const double* b,
                double* x, long long lanes, int n, int nrhs, void* stream) {
  return lu_solve_entry(LU, perm, b, x, lanes, n, nrhs, stream);
}
int pk_lu_solve_f32(const float* LU, const int* perm, const float* b,
                    float* x, long long lanes, int n, int nrhs,
                    void* stream) {
  return lu_solve_entry(LU, perm, b, x, lanes, n, nrhs, stream);
}

// `work`: the workspace's elements per lane (pk_factor_solve_workspace,
// or its _f32 twin), or nullptr where that is 0.
int pk_factor_solve(const double* A, const double* b, double* x,
                    double* work, long long lanes, int n, int nrhs,
                    void* stream) {
  return factor_solve_entry(A, b, x, work, lanes, n, nrhs, stream);
}
int pk_factor_solve_f32(const float* A, const float* b, float* x,
                        float* work, long long lanes, int n, int nrhs,
                        void* stream) {
  return factor_solve_entry(A, b, x, work, lanes, n, nrhs, stream);
}

}  // extern "C"
