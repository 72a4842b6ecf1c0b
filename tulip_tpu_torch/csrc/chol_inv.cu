// Batched inverse Cholesky factor of small SPD matrices, f32, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel tulip_tpu/ops/chol.py:_batched_chol_inv_kernel
// (reached through batched_cholesky_inverse_pallas, chol.py:192), the
// factorization stage of the f32 batched IPM (PallasSmallK1Backend.update).
// For each K (m x m) of a batch it returns L^-1 with K = L L^T: a
// right-looking rank-1 Cholesky, then L^-1 by forward substitution. Entries
// above the diagonal are written as exact zeros. A non-positive pivot
// leaves NaN/Inf in that instance's output and in no other (1/sqrt of a
// non-positive number); nothing is raised, callers test isfinite.
//
// What bounds it: at the batched solver's shapes (m = 48, B = 2048) one
// instance is m^3/3 ~ 37k FMAs on 9 KB of data, so neither the FLOP rate nor
// device-memory bandwidth is the limit. It is latency: m dependent column
// steps, each a few shared-memory operations between two block barriers,
// then a serial forward substitution of length m per column.
//
// What the design does about it: one thread block per instance keeps the
// whole matrix in shared memory (row stride m + 1 so column walks hit
// distinct banks) and touches device memory once per element on the way in
// and once on the way out. The latency of one instance's barriers is hidden
// by the other instances: at m = 48 a block needs ~9.6 KB of shared memory
// and 128 threads, so 16 blocks are resident on each of the 132 SMs and a
// batch of 2048 runs in about one wave. L^-1 is formed in place in the
// upper triangle, which the factorization leaves free, so one m x (m + 1)
// buffer serves both phases.
//
// Above m = 224 the matrix no longer fits in shared memory; the same
// algorithm then works in place in the output buffer in device memory
// (L2-resident at these sizes) with 1024 threads per instance. The IPM's
// shape buckets send m = 256, 512 and 1024 there. m > 1024 is refused,
// matching the reference's routing (kkt/pallas_chol.py:117).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC, without --use_fast_math: the pivots need the IEEE
// 1/sqrtf that the TPU kernel also insists on (chol.py:20).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxM = 1024;
constexpr int kSharedMaxM = 224;

// Factor and invert one instance held in S (lower triangle valid on entry,
// row stride ld). On exit X = L^-1 is stored transposed in the upper
// triangle: X[i][c] at S[c * ld + i] for i >= c. Ld and col are m-float
// shared arrays for L's diagonal and the current column of L.
__device__ void factor_and_invert(float* S, int ld, float* Ld, float* col,
                                  int m) {
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = nthreads >> 5;

  // Phase 1: right-looking Cholesky. Column j of L replaces S's column j
  // below the diagonal; its diagonal goes to Ld, so S[j][j] is only read.
  for (int j = 0; j < m; ++j) {
    const float p = S[j * ld + j];
    const float r = 1.0f / sqrtf(p);
    for (int i = j + tid; i < m; i += nthreads) {
      const float v = (i == j ? p : S[i * ld + j]) * r;
      col[i] = v;
      if (i == j) {
        Ld[j] = v;
      } else {
        S[i * ld + j] = v;
      }
    }
    __syncthreads();
    // Rank-1 update of the trailing lower triangle, j < k <= i < m: a warp
    // per row, lanes along the row.
    for (int i = j + 1 + warp; i < m; i += nwarps) {
      const float li = col[i];
      float* row = S + static_cast<size_t>(i) * ld;
      for (int k = j + 1 + lane; k <= i; k += 32) row[k] -= li * col[k];
    }
    __syncthreads();
  }

  // Phase 2: column c of X = L^-1 by forward substitution, one thread per
  // column. Thread c writes only row c of S at or right of the diagonal and
  // reads L strictly below the diagonal, so the threads never collide.
  for (int c = tid; c < m; c += nthreads) {
    float* xc = S + static_cast<size_t>(c) * ld;
    xc[c] = 1.0f / Ld[c];
    for (int i = c + 1; i < m; ++i) {
      const float* Li = S + static_cast<size_t>(i) * ld;
      float acc = 0.0f;
      for (int k = c; k < i; ++k) acc += Li[k] * xc[k];
      xc[i] = -acc / Ld[i];
    }
  }
  __syncthreads();
}

template <bool kShared>
__global__ void chol_inv_kernel(const float* __restrict__ K, float* out,
                                int m) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * m * m;
  const float* Kb = K + base;
  float* Ob = out + base;
  float* Ld = smem;
  float* col = smem + m;
  float* S = kShared ? smem + 2 * m : Ob;
  const int ld = kShared ? m + 1 : m;

  for (int e = tid; e < m * m; e += nthreads) {
    const int i = e / m;
    const int k = e - i * m;
    if (k <= i) S[i * ld + k] = Kb[e];
  }
  __syncthreads();

  factor_and_invert(S, ld, Ld, col, m);

  if (kShared) {
    for (int e = tid; e < m * m; e += nthreads) {
      const int i = e / m;
      const int c = e - i * m;
      Ob[e] = c <= i ? S[c * ld + i] : 0.0f;
    }
  } else {
    // X sits transposed in the upper triangle of Ob: move it below the
    // diagonal, then clear the upper triangle.
    for (int e = tid; e < m * m; e += nthreads) {
      const int i = e / m;
      const int c = e - i * m;
      if (c < i) Ob[e] = Ob[static_cast<size_t>(c) * m + i];
    }
    __syncthreads();
    for (int e = tid; e < m * m; e += nthreads) {
      const int i = e / m;
      const int c = e - i * m;
      if (c > i) Ob[e] = 0.0f;
    }
  }
}

}  // namespace

// L^-1 for `batch` row-major SPD matrices K (batch, m, m) into `out` (same
// shape, must not alias K), launched on `stream` of `device`. Returns the
// cudaError_t of the launch (0 on success); does not synchronise.
extern "C" int tulip_chol_inv_f32(const float* K, float* out, int batch,
                                  int m, int device, void* stream) {
  if (batch <= 0 || m <= 0 || m > kMaxM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool shared = m <= kSharedMaxM;
  const int threads = m <= 64 ? 128 : (shared ? 256 : 1024);
  const size_t smem =
      (2 * static_cast<size_t>(m) +
       (shared ? static_cast<size_t>(m) * (m + 1) : 0)) * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (shared) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(chol_inv_kernel<true>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    chol_inv_kernel<true><<<batch, threads, smem, s>>>(K, out, m);
  } else {
    chol_inv_kernel<false><<<batch, threads, smem, s>>>(K, out, m);
  }
  return static_cast<int>(cudaGetLastError());
}
