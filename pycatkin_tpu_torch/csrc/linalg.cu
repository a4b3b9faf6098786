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
// pycatkin_tpu/ops/linalg.py _lu_step / lu_solve share):
//   * partial pivoting; the pivot of column k is the FIRST row r >= k
//     attaining max |A[r, k]| (ties go to the smallest row index);
//   * multipliers A[i, k] / A[k, k] are stored below the diagonal, the
//     rank-1 update is A[i, j] - f_i * A[k, j] rounded as a separate
//     multiply and subtract (__dmul_rn / __dsub_rn: no FMA contraction,
//     so LU and perm match the plain PyTorch version bit for bit);
//   * perm[r] is the original row now at row r (int32); solves apply
//     b[perm], a unit-lower forward pass, then an upper backward pass.
//   The substitution passes here are column-oriented (each finished
//   unknown is subtracted from the rows still open), so x agrees with
//   the row-dot recurrences of the plain version to rounding order only.
//   A singular or NaN lane divides by a zero / NaN pivot and comes out
//   non-finite; lanes never touch each other's data.
//
// Design and what bounds it on an H100. One thread block per lane, the
// TPU's one grid program per lane: the lane's matrix (n*n doubles, 3.5
// KB at n = 21, 128 KB at n = 128) stays in shared memory through the
// whole elimination, so device memory sees each input read once and
// each output written once -- about 2*n*n*8 bytes a lane, against
// ~(2/3)n^3 FP64 operations. At the sweep's n = 21 that is ~0.6 FLOP
// per byte, far below the card's FP64 ridge, so the kernels are bound
// by memory traffic in principle; in practice this first version is
// bound by latency inside the block (n-1 dependent elimination steps,
// each with a pivot reduction and ~3 block barriers, little
// parallelism at small n). Later work: several lanes per block, one
// warp per lane with register-resident rows, cp.async staging.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 128;

__device__ __forceinline__ double upd(double a, double f, double u) {
  return __dsub_rn(a, __dmul_rn(f, u));
}

// Threads per block for systems of size n (warp 0 runs the pivot search,
// so at least one full warp).
inline int threads_for(int n) {
  if (n <= 16) return 64;
  if (n <= 32) return 128;
  return 256;
}

// In-place partial-pivoted LU of one lane's row-major [n, n] matrix `a`
// in shared memory. `perm` ([n] int, shared) receives the permutation,
// `f` ([n] double, shared) is scratch for the column multipliers.
__device__ void factor_lane(double* a, int* perm, double* f, int n) {
  __shared__ int s_pivot;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = tid; i < n; i += nt) perm[i] = i;
  __syncthreads();
  for (int k = 0; k < n - 1; ++k) {
    if (tid < 32) {
      // Each lane of warp 0 scans rows k+tid, k+tid+32, ... in
      // increasing order keeping the first maximum; the shuffle
      // reduction then prefers the larger value, the smaller row on a
      // tie. NaN entries never win; an all-NaN column keeps row k.
      double best = -1.0;
      int row = n;
      for (int r = k + tid; r < n; r += 32) {
        const double v = fabs(a[r * n + k]);
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
      if (tid == 0) s_pivot = row < n ? row : k;
    }
    __syncthreads();
    const int p = s_pivot;
    if (p != k) {
      for (int j = tid; j < n; j += nt) {
        const double t = a[k * n + j];
        a[k * n + j] = a[p * n + j];
        a[p * n + j] = t;
      }
      if (tid == 0) {
        const int t = perm[k];
        perm[k] = perm[p];
        perm[p] = t;
      }
      __syncthreads();
    }
    const double pivot = a[k * n + k];
    for (int i = k + 1 + tid; i < n; i += nt) f[i] = a[i * n + k] / pivot;
    __syncthreads();
    const int cols = n - k;
    const int count = (n - k - 1) * cols;
    for (int e = tid; e < count; e += nt) {
      const int i = k + 1 + e / cols;
      const int j = k + e % cols;
      a[i * n + j] = (j == k) ? f[i] : upd(a[i * n + j], f[i], a[k * n + j]);
    }
    __syncthreads();
  }
}

// Solve (LU) x = y in place for one lane: `lu` is the row-major [n, n]
// factorization (shared or device memory), `y` the permuted right-hand
// sides [n, nrhs] in shared memory.
__device__ void solve_lane(const double* lu, double* y, int n, int nrhs) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = 0; i < n - 1; ++i) {
    const int count = (n - 1 - i) * nrhs;
    for (int e = tid; e < count; e += nt) {
      const int j = i + 1 + e / nrhs;
      const int c = e % nrhs;
      y[j * nrhs + c] = upd(y[j * nrhs + c], lu[j * n + i], y[i * nrhs + c]);
    }
    __syncthreads();
  }
  for (int i = n - 1; i >= 0; --i) {
    const double d = lu[i * n + i];
    for (int c = tid; c < nrhs; c += nt) y[i * nrhs + c] = y[i * nrhs + c] / d;
    __syncthreads();
    const int count = i * nrhs;
    for (int e = tid; e < count; e += nt) {
      const int j = e / nrhs;
      const int c = e % nrhs;
      y[j * nrhs + c] = upd(y[j * nrhs + c], lu[j * n + i], y[i * nrhs + c]);
    }
    __syncthreads();
  }
}

__global__ void lu_factor_kernel(const double* __restrict__ A,
                                 double* __restrict__ LU,
                                 int* __restrict__ perm, int n) {
  extern __shared__ double smem[];
  double* a = smem;
  double* f = a + n * n;
  int* p = reinterpret_cast<int*>(f + n);
  const long long lane = blockIdx.x;
  const long long nn = static_cast<long long>(n) * n;
  const double* src = A + lane * nn;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) a[e] = src[e];
  __syncthreads();
  factor_lane(a, p, f, n);
  double* dst = LU + lane * nn;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) dst[e] = a[e];
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
  const int* pl = perm + lane * n;
  const double* bl = b + lane * nk;
  for (int e = threadIdx.x; e < n * nrhs; e += blockDim.x) {
    const int r = e / nrhs;
    const int c = e % nrhs;
    y[e] = bl[pl[r] * nrhs + c];
  }
  __syncthreads();
  solve_lane(LU + lane * static_cast<long long>(n) * n, y, n, nrhs);
  double* xl = x + lane * nk;
  for (int e = threadIdx.x; e < n * nrhs; e += blockDim.x) xl[e] = y[e];
}

__global__ void factor_solve_kernel(const double* __restrict__ A,
                                    const double* __restrict__ b,
                                    double* __restrict__ x, int n,
                                    int nrhs) {
  extern __shared__ double smem[];
  double* a = smem;
  double* f = a + n * n;
  double* y = f + n;
  int* p = reinterpret_cast<int*>(y + n * nrhs);
  const long long lane = blockIdx.x;
  const long long nn = static_cast<long long>(n) * n;
  const long long nk = static_cast<long long>(n) * nrhs;
  const double* src = A + lane * nn;
  for (int e = threadIdx.x; e < n * n; e += blockDim.x) a[e] = src[e];
  __syncthreads();
  factor_lane(a, p, f, n);
  const double* bl = b + lane * nk;
  for (int e = threadIdx.x; e < n * nrhs; e += blockDim.x) {
    const int r = e / nrhs;
    const int c = e % nrhs;
    y[e] = bl[p[r] * nrhs + c];
  }
  __syncthreads();
  solve_lane(a, y, n, nrhs);
  double* xl = x + lane * nk;
  for (int e = threadIdx.x; e < n * nrhs; e += blockDim.x) xl[e] = y[e];
}

// Opt a kernel into more than 48 KB of dynamic shared memory when the
// lane needs it (n = 128 needs ~130 KB).
template <typename K>
cudaError_t reserve_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

int pk_max_n() { return kMaxN; }

// Shared memory a lane of each kernel needs, in bytes (the wrapper
// checks it against the card's per-block limit before launching).
long long pk_lu_factor_smem(int n) {
  return (static_cast<long long>(n) * n + n) * 8 + n * 4;
}

long long pk_lu_solve_smem(int n, int nrhs) {
  return static_cast<long long>(n) * nrhs * 8;
}

long long pk_factor_solve_smem(int n, int nrhs) {
  return (static_cast<long long>(n) * n + n + static_cast<long long>(n) *
          nrhs) * 8 + n * 4;
}

int pk_lu_factor(const double* A, double* LU, int* perm, long long lanes,
                 int n, void* stream) {
  if (n < 1 || n > kMaxN || lanes < 1) return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(pk_lu_factor_smem(n));
  cudaError_t err = reserve_smem(lu_factor_kernel, bytes);
  if (err != cudaSuccess) return err;
  lu_factor_kernel<<<static_cast<unsigned int>(lanes), threads_for(n), bytes,
                     static_cast<cudaStream_t>(stream)>>>(A, LU, perm, n);
  return cudaGetLastError();
}

int pk_lu_solve(const double* LU, const int* perm, const double* b,
                double* x, long long lanes, int n, int nrhs, void* stream) {
  if (n < 1 || n > kMaxN || nrhs < 1 || lanes < 1)
    return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(pk_lu_solve_smem(n, nrhs));
  cudaError_t err = reserve_smem(lu_solve_kernel, bytes);
  if (err != cudaSuccess) return err;
  lu_solve_kernel<<<static_cast<unsigned int>(lanes), threads_for(n), bytes,
                    static_cast<cudaStream_t>(stream)>>>(LU, perm, b, x, n,
                                                         nrhs);
  return cudaGetLastError();
}

int pk_factor_solve(const double* A, const double* b, double* x,
                    long long lanes, int n, int nrhs, void* stream) {
  if (n < 1 || n > kMaxN || nrhs < 1 || lanes < 1)
    return cudaErrorInvalidValue;
  const size_t bytes = static_cast<size_t>(pk_factor_solve_smem(n, nrhs));
  cudaError_t err = reserve_smem(factor_solve_kernel, bytes);
  if (err != cudaSuccess) return err;
  factor_solve_kernel<<<static_cast<unsigned int>(lanes), threads_for(n),
                        bytes, static_cast<cudaStream_t>(stream)>>>(
      A, b, x, n, nrhs);
  return cudaGetLastError();
}

}  // extern "C"
