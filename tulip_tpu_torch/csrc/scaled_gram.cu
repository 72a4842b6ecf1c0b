// Batched scaled Gram matrix K = A diag(d) A^T, f32, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// tulip_tpu/kkt/pallas_chol.py:_scaled_gram_kernel (reached through
// scaled_gram, pallas_chol.py:53), the K-formation stage of the
// "dense-pallas" K1 backend (PallasK1Backend.update). For each lane b of a
// batch, A[b] is m x n row-major and d[b] has n entries:
//
//   K[b][i][j] = sum_k (A[b][i][k] * d[b][k]) * A[b][j][k]
//
// d scales the row side (i) only, as the TPU kernel does (ai_ref * d_ref,
// pallas_chol.py:44), and there is no diagonal term: the caller adds Rd.
//
// Only the tiles on or below the diagonal (i-tile >= j-tile) are computed;
// each computed entry with i >= j is written to K[i][j] and mirrored to
// K[j][i]. That halves the work and makes K exactly symmetric, which the
// TPU kernel's K is not (it computes every tile, with d on the row side of
// each). The Cholesky that follows reads the lower triangle only, so the
// mirror changes no factor; it keeps K a valid symmetric matrix for any
// other reader.
//
// What bounds it: at the dense-pallas path's shape (m = 4096, n = 6240) one
// formation is m^2 n ~ 105 GFLOP with the mirror on 102 MB of A, so it is
// compute-bound (~1000 FLOP per byte of A). In f32 without TF32 the
// only units are the SM's FP32 FMA pipes (67 TFLOP/s published, H100 SXM).
//
// What the design does about it: a classic SIMT tiling. One 256-thread
// block computes a 128 x 128 tile of K and loops over k in chunks of 8 (the
// TPU's sequential "arbitrary" grid axis becomes this loop: nothing carries
// between blocks on Hopper). Per chunk the block stages the 128 i-rows,
// scaled by d on the way in, and the 128 j-rows in shared memory,
// transposed to [k][row] with a row stride of 132 floats so the transposing
// stores hit 32 distinct banks and the float4 reads stay 16-byte aligned.
// Each thread keeps an 8 x 8 tile of sums in registers (rows ty*4..+3 and
// 64+ty*4..+3, columns likewise with tx), so one k step is 4 float4 shared
// loads for 64 FMAs. The next chunk's global loads are issued into
// registers before the current chunk's FMAs. Ragged edges in m and n are
// masked in the kernel (zero fill on load, no store), not padded by the
// host. Accumulation is plain f32 FMA: no TF32, no tensor cores, no
// --use_fast_math, so K keeps f32's digits. wgmma/TMA and a 3xTF32 split
// are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 128;            // rows (and columns) of a K tile
constexpr int kChunk = 8;             // k values staged per step
constexpr int kThreads = 256;
constexpr int kStride = kTile + 4;    // shared row stride, in floats
constexpr int kLoads = kTile * kChunk / kThreads;  // per thread, per side

__global__ void __launch_bounds__(kThreads)
scaled_gram_kernel(const float* __restrict__ A, const float* __restrict__ d,
                   float* __restrict__ K, int m, int n) {
  const int ti = blockIdx.x;  // i-tile
  const int tj = blockIdx.y;  // j-tile
  if (tj > ti) return;        // upper tiles come from the mirror
  const size_t lane = blockIdx.z;
  const float* Ab = A + lane * static_cast<size_t>(m) * n;
  const float* db = d + lane * static_cast<size_t>(n);
  float* Kb = K + lane * static_cast<size_t>(m) * m;

  __shared__ __align__(16) float Si[kChunk][kStride];
  __shared__ __align__(16) float Sj[kChunk][kStride];

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;

  // Load slot e of this thread covers tile row r = (tid + e*256) / 8 and
  // chunk column c = tid % 8: eight neighbouring threads read eight
  // neighbouring floats of one row.
  const int c = tid % kChunk;
  float ri[kLoads], rj[kLoads];

  auto fetch = [&](int k0) {
    const int k = k0 + c;
    const bool kin = k < n;
    const float dk = kin ? db[k] : 0.0f;
#pragma unroll
    for (int e = 0; e < kLoads; ++e) {
      const int r = (tid + e * kThreads) / kChunk;
      const int gi = i0 + r;
      const int gj = j0 + r;
      ri[e] = (kin && gi < m) ? Ab[static_cast<size_t>(gi) * n + k] * dk
                              : 0.0f;
      rj[e] = (kin && gj < m) ? Ab[static_cast<size_t>(gj) * n + k] : 0.0f;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a) {
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.0f;
  }

  fetch(0);
  for (int k0 = 0; k0 < n; k0 += kChunk) {
#pragma unroll
    for (int e = 0; e < kLoads; ++e) {
      const int r = (tid + e * kThreads) / kChunk;
      Si[c][r] = ri[e];
      Sj[c][r] = rj[e];
    }
    __syncthreads();
    if (k0 + kChunk < n) fetch(k0 + kChunk);

#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      float a[8], b[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&Si[kk][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&Si[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Sj[kk][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Sj[kk][64 + tx * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
      b[0] = b0.x; b[1] = b0.y; b[2] = b0.z; b[3] = b0.w;
      b[4] = b1.x; b[5] = b1.y; b[6] = b1.z; b[7] = b1.w;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
#pragma unroll
        for (int q = 0; q < 8; ++q) acc[p][q] = fmaf(a[p], b[q], acc[p][q]);
      }
    }
    __syncthreads();
  }

  // Entries with i >= j go to K[i][j] and, off the diagonal, to K[j][i].
#pragma unroll
  for (int p = 0; p < 8; ++p) {
    const int gi = i0 + (p < 4 ? ty * 4 + p : 64 + ty * 4 + (p - 4));
    if (gi >= m) continue;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int gj = j0 + (q < 4 ? tx * 4 + q : 64 + tx * 4 + (q - 4));
      if (gj >= m || gj > gi) continue;
      Kb[static_cast<size_t>(gi) * m + gj] = acc[p][q];
      if (gj != gi) Kb[static_cast<size_t>(gj) * m + gi] = acc[p][q];
    }
  }
}

}  // namespace

// K (batch, m, m) = A diag(d) A^T for row-major A (batch, m, n) and d
// (batch, n), f32, launched on `stream` of `device`. K must not alias A or
// d. Returns the cudaError_t of the launch (0 on success); does not
// synchronise.
extern "C" int tulip_scaled_gram_f32(const float* A, const float* d, float* K,
                                     int batch, int m, int n, int device,
                                     void* stream) {
  if (batch <= 0 || batch > 65535 || m <= 0 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (m + kTile - 1) / kTile;
  if (tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(tiles, tiles, batch);
  scaled_gram_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      A, d, K, m, n);
  return static_cast<int>(cudaGetLastError());
}
