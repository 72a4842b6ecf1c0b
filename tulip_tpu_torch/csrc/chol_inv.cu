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
// Packed variant (tulip_chol_inv_packed_f32): replaces
// tulip_tpu/ops/chol.py:_packed_chol_inv_kernel (pack > 1 in
// batched_cholesky_inverse_pallas, chol.py:223). On the TPU, packing laid p
// instances side by side in the 128 lanes of the vector unit, which at
// m = 48 left 62% of every operation idle. Lanes have no counterpart here;
// the matching waste on Hopper is a 128-thread block per instance whose
// threads mostly wait at its barriers (48 of them have a column in the
// forward substitution), and a batch of 2048 at 34 registers x 128 threads
// that needs two waves. The packed launch puts p instances in one block,
// each on its own group of threads: one warp per instance for m <= 32,
// synchronised with __syncwarp; two warps for m <= 64 and four above, each
// group synchronised with its own named barrier (bar.sync 1 + g, count), so
// no group waits for another. Smaller groups let more instances share an
// SM's registers. Where p instances do not fit in shared memory, in 1024
// threads or in the 15 named barriers, the launcher lowers p to what fits;
// at p = 1 (always for m > 224, whose instances live in device memory) it
// makes the unpacked launch.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC, without --use_fast_math: the pivots need the IEEE
// 1/sqrtf that the TPU kernel also insists on (chol.py:20).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxM = 1024;
constexpr int kSharedMaxM = 224;
// Named barrier ids 1..15 (0 is __syncthreads'): at most 15 groups a block.
constexpr int kMaxNamedGroups = 15;

// Barriers over the threads that work on one instance: the whole block, one
// warp, or a named barrier over a group of whole warps.
struct BlockBarrier {
  __device__ void operator()() const { __syncthreads(); }
};

// Group g of a packed block: the group is one whole warp.
struct WarpBarrier {
  __device__ WarpBarrier(int, int) {}
  __device__ void operator()() const { __syncwarp(); }
};

// Group g of a packed block: `group` threads on named barrier 1 + g.
struct NamedBarrier {
  int id;
  int count;
  __device__ NamedBarrier(int g, int group) : id(1 + g), count(group) {}
  __device__ void operator()() const {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
  }
};

// Factor and invert one instance held in S (lower triangle valid on entry,
// row stride ld) with threads tid = 0 .. nthreads - 1 (a multiple of 32)
// that `bar` synchronises. On exit X = L^-1 is stored transposed in the
// upper triangle: X[i][c] at S[c * ld + i] for i >= c. Ld and col are
// m-float arrays for L's diagonal and the current column of L.
template <class Barrier>
__device__ void factor_and_invert(float* S, int ld, float* Ld, float* col,
                                  int m, int tid, int nthreads,
                                  Barrier bar) {
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
    bar();
    // Rank-1 update of the trailing lower triangle, j < k <= i < m: a warp
    // per row, lanes along the row.
    for (int i = j + 1 + warp; i < m; i += nwarps) {
      const float li = col[i];
      float* row = S + static_cast<size_t>(i) * ld;
      for (int k = j + 1 + lane; k <= i; k += 32) row[k] -= li * col[k];
    }
    bar();
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
  bar();
}

// One instance in shared memory (smem: Ld, col, then S with row stride
// m + 1): load the lower triangle of Kb, factor, invert, and write L^-1 with
// exact zeros above the diagonal to Ob.
template <class Barrier>
__device__ void shared_instance(const float* __restrict__ Kb, float* Ob,
                                float* smem, int m, int tid, int nthreads,
                                Barrier bar) {
  float* Ld = smem;
  float* col = smem + m;
  float* S = smem + 2 * m;
  const int ld = m + 1;
  for (int e = tid; e < m * m; e += nthreads) {
    const int i = e / m;
    const int k = e - i * m;
    if (k <= i) S[i * ld + k] = Kb[e];
  }
  bar();
  factor_and_invert(S, ld, Ld, col, m, tid, nthreads, bar);
  for (int e = tid; e < m * m; e += nthreads) {
    const int i = e / m;
    const int c = e - i * m;
    Ob[e] = c <= i ? S[c * ld + i] : 0.0f;
  }
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
  if (kShared) {
    shared_instance(Kb, Ob, smem, m, tid, nthreads, BlockBarrier{});
  } else {
    // The same algorithm in place in Ob (row stride m); only Ld and col
    // live in shared memory.
    float* Ld = smem;
    float* col = smem + m;
    for (int e = tid; e < m * m; e += nthreads) {
      const int i = e / m;
      const int k = e - i * m;
      if (k <= i) Ob[e] = Kb[e];
    }
    __syncthreads();
    factor_and_invert(Ob, m, Ld, col, m, tid, nthreads, BlockBarrier{});
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

// p instances per block, each on a group of `group` threads (a multiple of
// 32) with its own slice of shared memory; Barrier is WarpBarrier for
// group == 32, else NamedBarrier.
template <class Barrier>
__global__ void chol_inv_packed_kernel(const float* __restrict__ K, float* out,
                                       int m, int batch, int group) {
  extern __shared__ float smem[];
  const int g = threadIdx.x / group;
  const int tid = threadIdx.x - g * group;
  const int p = blockDim.x / group;
  const int inst = blockIdx.x * p + g;
  if (inst >= batch) return;
  const size_t base = static_cast<size_t>(inst) * m * m;
  float* mine = smem + static_cast<size_t>(g) * (2 * m + m * (m + 1));
  shared_instance(K + base, out + base, mine, m, tid, group,
                  Barrier(g, group));
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

// The packed launch: as tulip_chol_inv_f32, with up to `pack` instances per
// block. The launcher lowers pack to what fits (shared memory, 1024 threads,
// 15 named barriers, the batch) and writes the count it used to `*used`;
// at 1 it makes the unpacked launch.
extern "C" int tulip_chol_inv_packed_f32(const float* K, float* out, int batch,
                                         int m, int pack, int device,
                                         void* stream, int* used) {
  if (batch <= 0 || m <= 0 || m > kMaxM || pack < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group = m <= 32 ? 32 : (m <= 64 ? 64 : 128);
  const size_t per = (2 * static_cast<size_t>(m) +
                      static_cast<size_t>(m) * (m + 1)) * sizeof(float);
  int p = pack;
  if (m > kSharedMaxM) p = 1;
  p = p < 1024 / group ? p : 1024 / group;
  if (group > 32 && p > kMaxNamedGroups) p = kMaxNamedGroups;
  const int fit = static_cast<int>(static_cast<size_t>(max_smem) / per);
  p = p < fit ? p : fit;
  p = p < batch ? p : batch;
  if (p <= 1) {
    *used = 1;
    return tulip_chol_inv_f32(K, out, batch, m, device, stream);
  }
  const size_t smem = per * p;
  const int blocks = (batch + p - 1) / p;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group == 32) {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(chol_inv_packed_kernel<WarpBarrier>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    chol_inv_packed_kernel<WarpBarrier><<<blocks, p * group, smem, s>>>(
        K, out, m, batch, group);
  } else {
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(chol_inv_packed_kernel<NamedBarrier>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    chol_inv_packed_kernel<NamedBarrier><<<blocks, p * group, smem, s>>>(
        K, out, m, batch, group);
  }
  *used = p;
  return static_cast<int>(cudaGetLastError());
}
