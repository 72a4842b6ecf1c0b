// Batched inverse Cholesky factor of small SPD matrices, f32, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel tulip_tpu/ops/chol.py:_batched_chol_inv_kernel
// (reached through batched_cholesky_inverse_pallas, chol.py:192), the
// factorization stage of the f32 batched IPM (PallasSmallK1Backend.update).
// For each K (m x m) of a batch it returns L^-1 with K = L L^T. Entries
// above the diagonal are written as exact zeros. A non-positive pivot
// leaves NaN/Inf in that instance's output and in no other (1/sqrt of a
// non-positive number); nothing is raised, callers test isfinite.
//
// Both paths work in panels of kNb = 32 columns. For each panel j one warp
// holds the 32 x 32 diagonal block W_jj with row i in lane i's registers
// and factors it, pivots and columns travelling by __shfl_sync with no
// barrier; then the panel below and the trailing update W_ik -= L_ij L_kj^T
// follow, and L^-1 is formed block row by block row. The longest serial
// chain is a 32-column factorization a panel and 16-deep substitutions,
// not the m dependent pivots between block barriers and the m^2/2-long
// forward substitution of a column-at-a-time Cholesky. No tile skips work
// on account of its values, so a bad pivot in any panel spreads NaN
// through the panel and the trailing products to the rest of its
// instance, and instances never share a tile.
//
// Shared-memory path (m <= 224). What bounds it: at the batched solver's
// shapes (m = 48, B = 2048) one instance is ~2m^3/3 ~ 74k operations on
// 18 KB of input and output, so neither the FLOP rate nor device-memory
// bandwidth is the limit; it is the latency of each instance's dependent
// steps, hidden only by running many instances on each SM. So one group of
// threads works on each instance with the whole matrix in its slice of
// shared memory: one warp for m <= 64, 4 warps up to 128 and 8 above. The
// slice holds S, m rows of stride m + 1 (so that column walks and a thread
// a row hit distinct banks), with L in the lower triangle and X = L^-1
// stored transposed in the strict upper triangle (X[i][c] at S[c][i]), and
// each pivot's r = 1 / sqrtf(p) in m floats beside it: (m + 2) m floats,
// 9.6 KB at m = 48, and no device scratch. The ragged last panel is padded
// in registers, not in memory: lanes at or past its last row take an
// identity row and write nothing back. Only K's lower triangle is read,
// in batches of 16 loads a thread, so that their latency is paid a few
// times and not m^2/32 times.
// Every step but the factor, which one warp runs, is spread over the
// group: a thread a row of the panel below, 4 x 4 tiles of the trailing
// update, a thread a column of L^-1 (16 rows at a time: 16 independent sums
// over the columns to their left, then a chain of at most 16 among them). A
// panel costs 3 barriers (__syncwarp for a one-warp group, the group's
// named barrier otherwise). At m = 48 a group is one warp and ~10 KB, so
// 16 or more groups share an SM and a batch of 2048 runs in one wave of
// 132 SMs.
//
// The blocking changes when each operation runs, not what it computes:
// every element of L and of L^-1 is the same sequence of IEEE operations
// as in a column-at-a-time Cholesky with forward substitution (updates
// subtracted by FMA in column order, L[i][j] = w * r, x[i] =
// -(sum_{c <= k < i} L[i][k] x[k]) / L[i][i] summed in k order, x[c] =
// 1 / L[c][c]). So the output does not depend on the group size or on the
// packing, and the batched solver iterates exactly as it did with the
// column-at-a-time kernel this path replaced. Products with X_jj in the
// panel and a block inverse, tried first, were as fast but rounded
// differently, which moved the slice's mean iteration count.
//
// The unpacked launch (tulip_chol_inv_f32) runs one group a block; the
// packed launch (tulip_chol_inv_packed_f32) replaces
// tulip_tpu/ops/chol.py:_packed_chol_inv_kernel (pack > 1 in
// batched_cholesky_inverse_pallas, chol.py:223), which laid p instances
// side by side in the 128 lanes of the TPU's vector unit. Lanes have no
// counterpart here; the packed launch puts p groups in one block, each on
// its own slice of shared memory and its own barrier (bar.sync 1 + g), so
// no group waits for another. Both run the same kernel body, so their
// outputs are the same bits. Where p instances do not fit in shared
// memory or in 512 threads, the launcher lowers p to what fits; at p = 1 (always for m > 224, whose instances live in
// device memory) it makes the unpacked launch.
//
// Blocked path (224 < m <= 1024): the matrix no longer fits in shared
// memory, and one block per instance would leave the card idle at the
// single LP's B = 1 (one SM of 132 working). What bounds it is the
// critical path: m dependent pivots. So each step of a panel is a kernel
// spread over many blocks, on a working copy W padded to a multiple of 32
// with an identity tail (so no inner kernel masks anything):
//
//   panel kernel   every block factors W_jj and inverts it, X_jj =
//                  L_jj^-1 (warp 0), rather than wait for a launch of its
//                  own (~3 us), then forms 32 rows of the panel below as a
//                  product, L_ij = W_ij X_jj^T, so no triangular solve is
//                  on the critical path; block 0 keeps X_jj.
//   update kernel  the trailing update over 64 x 64 lower tiles, one tile
//                  per block, f32 FMA.
//   inverse kernel L^-1 by blocks from the X_jj at hand,
//                  X_ij = -X_ii * sum_{j <= k < i} L_ik X_kj. Columns of L^-1
//                  are independent, so each block takes 8 columns of one
//                  block column and walks down it, its slice of X in
//                  shared memory; rows of L are read along k by a warp
//                  and reduced with shuffles. It also writes the exact
//                  zeros above the diagonal.
//
// That is 2 launches a panel plus 2, all enqueued by the one C entry point
// on the caller's stream with no synchronisation; W and the X_jj live in
// scratch that the caller allocates. m > 1024 is refused, matching the
// reference's routing (kkt/pallas_chol.py:117).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC, without --use_fast_math: the pivots need the IEEE
// 1/sqrtf that the TPU kernel also insists on (chol.py:20).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxM = 1024;
constexpr int kSharedMaxM = 224;
constexpr int kNb = 32;       // panel width: one row of a block per lane
constexpr int kLd = kNb + 1;  // shared row stride of a 32 x 32 block
constexpr unsigned kFull = 0xffffffffu;

// One warp factors the 32 x 32 block whose row `lane` (columns 0 .. lane;
// the rest zero) is in a[]: on return a[k] = L[lane][k] for k <= lane
// (entries right of the diagonal are left over from the updates). Returns
// r = 1 / sqrtf(p) of the lane's pivot, which is 1 / L[lane][lane]; L's
// column is the old column times r.
__device__ __forceinline__ float warp_factor(float (&a)[kNb], int lane) {
  float rdiag = 0.0f;
#pragma unroll
  for (int j = 0; j < kNb; ++j) {
    const float p = __shfl_sync(kFull, a[j], j);
    const float r = 1.0f / sqrtf(p);
    const float l = a[j] * r;  // L[lane][j], meaningful for lane >= j
    a[j] = l;
    if (lane == j) rdiag = r;
#pragma unroll
    for (int k = j + 1; k < kNb; ++k) {
      const float lk = __shfl_sync(kFull, l, k);  // L[k][j]
      a[k] = fmaf(-l, lk, a[k]);
    }
  }
  return rdiag;
}

// Barriers over the threads that work on one instance: one warp, or a
// named barrier over a group of whole warps.
struct WarpBarrier {
  __device__ WarpBarrier(int, int) {}
  __device__ void operator()() const { __syncwarp(); }
};

// Group g of a block: `group` threads on named barrier 1 + g.
struct NamedBarrier {
  int id;
  int count;
  __device__ NamedBarrier(int g, int group) : id(1 + g), count(group) {}
  __device__ void operator()() const {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
  }
};

// For diagnosis only (time_kernels.py --leave-out): a build with
// -DCHOL_LEAVE_OUT=1 drops the shared-memory path's loads and stores, 2
// its factorizations of the diagonal blocks, 3 its panels below and
// trailing updates, 4 its L^-1. Its output is wrong; only its time means
// anything.
#ifndef CHOL_LEAVE_OUT
#define CHOL_LEAVE_OUT 0
#endif

// Threads that work on one instance of the shared-memory path.
__host__ __device__ constexpr int small_group(int m) {
  return m <= 64 ? 32 : (m <= 128 ? 128 : 256);
}

// Floats of shared memory an instance of the shared-memory path needs.
__host__ __device__ constexpr size_t small_floats(int m) {
  return static_cast<size_t>(m) * (m + 2);
}

// Rows c0i .. c0i + nbi - 1 of column c of X = L^-1 (c0i at or below c's
// own block row, which starts at kbeg), by the column-at-a-time forward
// substitution x[i] = -(sum_{c <= k < i} L[i][k] x[k]) / L[i][i],
// x[c] = xcc = 1 / L[c][c], summed in that order. 16 rows at a time: first
// over the columns left of them (16 independent sums, one a row), then a
// chain of at most 16 among them. xc = S + c * ld holds x[k] at xc[k] for
// k > c.
template <bool kWhole>
__device__ __forceinline__ void forward_block(const float* S, float* xc,
                                              int ld, int c, float xcc,
                                              int kbeg, int c0i, int nbi) {
  constexpr int kRows = kNb / 2;
#pragma unroll
  for (int h = 0; h < kNb; h += kRows) {
    if (!kWhole && h >= nbi) break;
    const int r0 = c0i + h;
    float t[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) t[r] = 0.0f;
    for (int k = kbeg; k < r0; ++k) {
      const float xk = k < c ? 0.0f : (k == c ? xcc : xc[k]);
      const float* col = S + r0 * ld + k;  // L[r0 + r][k] at col[r * ld]
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (kWhole || h + r < nbi) t[r] = fmaf(col[r * ld], xk, t[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      if (kWhole || h + r < nbi) {
        const int i = r0 + r;
        const float* Li = S + i * ld + r0;
        float acc = t[r];
#pragma unroll
        for (int q = 0; q < r; ++q) acc = fmaf(Li[q], t[q], acc);
        t[r] = i < c ? 0.0f : (i == c ? xcc : -acc / Li[r]);
        if (i > c) xc[i] = t[r];
      }
    }
  }
}

// One instance of the shared-memory path, on threads tid = 0 .. nthreads - 1
// (a multiple of 32) that `bar` synchronises, in smem (small_floats(m)
// floats): load the lower triangle of Kb, factor by panels, form L^-1 by
// block rows, and write it with exact zeros above the diagonal to Ob.
template <class Barrier>
__device__ void small_instance(const float* __restrict__ Kb,
                               float* __restrict__ Ob, float* smem, int m,
                               int tid, int nthreads, Barrier bar) {
  constexpr int kLoads = 16;  // loads in flight a thread
  float* Rd = smem;           // r = 1 / sqrtf(pivot) of each column
  float* S = smem + m;
  const int ld = m + 1;
  const int lane = tid & 31;
  const int mm = m * m;
  // Element e = ei m + ek of this thread's stride walk, (ei, ek) advanced
  // without a division; only the lower triangle is read.
  int ei = tid / m;
  int ek = tid - ei * m;
  for (int e0 = tid; CHOL_LEAVE_OUT != 1 && e0 < mm;
       e0 += kLoads * nthreads) {
    float v[kLoads];
    int at[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * nthreads;
      const bool lower = e < mm && ek <= ei;
      at[u] = lower ? ei * ld + ek : -1;
      v[u] = lower ? Kb[e] : 0.0f;
      for (ek += nthreads; ek >= m; ek -= m) ++ei;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (at[u] >= 0) S[at[u]] = v[u];
    }
  }
  bar();

  for (int c0 = 0; c0 < m; c0 += kNb) {
    const int nb = m - c0 < kNb ? m - c0 : kNb;
    if (tid < 32 && CHOL_LEAVE_OUT != 2) {
      // Factor W_jj; lanes past its last row hold an identity row and
      // write nothing back.
      const bool real = lane < nb;
      float* w = S + (c0 + (real ? lane : 0)) * ld + c0;
      float a[kNb];
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
        a[k] = real ? (k <= lane ? w[k] : 0.0f) : (k == lane ? 1.0f : 0.0f);
      }
      const float rdiag = warp_factor(a, lane);
      if (real) {
#pragma unroll
        for (int k = 0; k < kNb; ++k) {
          if (k <= lane) w[k] = a[k];
        }
        Rd[c0 + lane] = rdiag;
      }
    }
    bar();
    const int below = c0 + kNb;
    if (below >= m) break;

    // The panel below, a thread a row, in place: column k is scaled by its
    // pivot's r once the columns left of it in the panel are subtracted,
    // in column order.
    for (int r = below + tid; CHOL_LEAVE_OUT != 3 && r < m;
         r += nthreads) {
      float* w = S + r * ld + c0;
      float v[kNb];
#pragma unroll
      for (int k = 0; k < kNb; ++k) v[k] = w[k];
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
        const float* Lk = S + (c0 + k) * ld + c0;  // row k of L_jj
#pragma unroll
        for (int j = 0; j < k; ++j) v[k] = fmaf(-v[j], Lk[j], v[k]);
        v[k] *= Rd[c0 + k];
      }
#pragma unroll
      for (int k = 0; k < kNb; ++k) w[k] = v[k];
    }
    bar();

    // Trailing update W_ik -= L_ij L_kj^T over the 4 x 4 tiles on or below
    // the diagonal of the trailing matrix, one column of the panel after
    // the other; rows past m are read as row m - 1 and not written.
    const int nt = (m - below + 3) / 4;
    const int tiles = nt * (nt + 1) / 2;
    for (int t = tid; CHOL_LEAVE_OUT != 3 && t < tiles; t += nthreads) {
      int ti = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
      while (ti * (ti + 1) / 2 > t) --ti;
      while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
      const int tk = t - ti * (ti + 1) / 2;
      const int i0 = below + 4 * ti;
      const int k0 = below + 4 * tk;
      int oi[4], ok[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        oi[a] = (i0 + a < m ? i0 + a : m - 1) * ld;
        ok[a] = (k0 + a < m ? k0 + a : m - 1) * ld;
      }
      float acc[4][4];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = S[oi[a] + k0 + b];
      }
#pragma unroll 8
      for (int q = c0; q < below; ++q) {
        float li[4], lk[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          li[a] = S[oi[a] + q];
          lk[a] = S[ok[a] + q];
        }
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            acc[a][b] = fmaf(-li[a], lk[b], acc[a][b]);
          }
        }
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int i = i0 + a;
          const int k = k0 + b;
          if (i < m && k <= i) S[i * ld + k] = acc[a][b];
        }
      }
    }
    bar();
  }

  // L^-1 a thread a column, block row by block row from the column's own.
  for (int c = tid; CHOL_LEAVE_OUT != 4 && c < m; c += nthreads) {
    const int kbeg = c / kNb * kNb;
    const float xcc = 1.0f / S[c * ld + c];
    float* xc = S + c * ld;
    for (int c0i = kbeg; c0i < m; c0i += kNb) {
      const int nbi = m - c0i;
      if (nbi >= kNb) {
        forward_block<true>(S, xc, ld, c, xcc, kbeg, c0i, kNb);
      } else {
        forward_block<false>(S, xc, ld, c, xcc, kbeg, c0i, nbi);
      }
    }
  }
  bar();

  ei = tid / m;
  ek = tid - ei * m;
  for (int e = tid; CHOL_LEAVE_OUT != 1 && e < mm; e += nthreads) {
    float v = 0.0f;
    if (ek < ei) {
      v = S[ek * ld + ei];
    } else if (ek == ei) {
      v = 1.0f / S[ek * ld + ek];
    }
    Ob[e] = v;
    for (ek += nthreads; ek >= m; ek -= m) ++ei;
  }
}

// The shared-memory path: blockDim.x / group instances a block, each on a
// group of `group` threads with its own slice of shared memory; Barrier is
// WarpBarrier for group == 32, else NamedBarrier. At most kSmallThreads a
// block, which holds a thread to 128 registers (16 one-warp groups an SM)
// and a block to 4 groups of more than one warp (named barriers 1..4 of
// the 15 there are).
constexpr int kSmallThreads = 512;

template <class Barrier>
__global__ void __launch_bounds__(kSmallThreads)
    chol_inv_kernel(const float* __restrict__ K, float* __restrict__ out,
                    int m, int batch, int group) {
  extern __shared__ float smem[];
  const int g = threadIdx.x / group;
  const int tid = threadIdx.x - g * group;
  const int inst = blockIdx.x * (blockDim.x / group) + g;
  if (inst >= batch) return;
  const size_t base = static_cast<size_t>(inst) * m * m;
  small_instance(K + base, out + base, smem + g * small_floats(m), m, tid,
                 group, Barrier(g, group));
}

template <class Barrier>
cudaError_t launch_small_as(const float* K, float* out, int batch, int m,
                            int p, cudaStream_t s) {
  const int group = small_group(m);
  const size_t smem = small_floats(m) * sizeof(float) * p;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chol_inv_kernel<Barrier>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  chol_inv_kernel<Barrier><<<(batch + p - 1) / p, p * group, smem, s>>>(
      K, out, m, batch, group);
  return cudaGetLastError();
}

// The shared-memory path with p instances a block (p = 1: the unpacked
// launch).
cudaError_t launch_small(const float* K, float* out, int batch, int m, int p,
                         cudaStream_t s) {
  if (small_group(m) == 32) {
    return launch_small_as<WarpBarrier>(K, out, batch, m, p, s);
  }
  return launch_small_as<NamedBarrier>(K, out, batch, m, p, s);
}

// ---------------------------------------------------------------------------
// The blocked path, 224 < m <= 1024. mp is m rounded up to a multiple of
// kNb; W is (batch, mp, mp), Xd is (batch, mp, kNb): rows 32 j .. 32 j + 31
// of Xd hold X_jj = L_jj^-1.
// ---------------------------------------------------------------------------

constexpr int kUpd = 64;         // rows (and columns) of an update tile
constexpr int kInvCols = 8;      // columns of L^-1 per inverse block

// W = K on the leading m x m, the identity on the padding.
__global__ void blocked_init_kernel(const float* __restrict__ K,
                                    float* __restrict__ W, int m, int mp,
                                    size_t total) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const size_t per = static_cast<size_t>(mp) * mp;
  const size_t b = e / per;
  const int r = static_cast<int>((e - b * per) / mp);
  const int c = static_cast<int>(e - b * per - static_cast<size_t>(r) * mp);
  float v = r == c ? 1.0f : 0.0f;
  if (r < m && c < m) v = K[(b * m + r) * m + c];
  W[e] = v;
}

// One warp factors the 32 x 32 block whose row `lane` (columns 0 .. lane;
// the rest zero) is in a[] (warp_factor), and leaves X = L^-1 row-major in
// Xs (stride kLd, exact zeros above the diagonal). Ls (32 x kLd) and rd
// (32) are scratch.
__device__ void warp_factor_invert(float (&a)[kNb], int lane, float* Ls,
                                   float* rd, float* Xs) {
  const float rdiag = warp_factor(a, lane);
#pragma unroll
  for (int k = 0; k < kNb; ++k) Ls[lane * kLd + k] = a[k];
  rd[lane] = rdiag;
  __syncwarp();
  // Column `lane` of X by forward substitution; every lane reads the same
  // L[i][k] (a broadcast), and the x of rows above the diagonal are zeros.
  float x[kNb];
#pragma unroll
  for (int i = 0; i < kNb; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int k = 0; k < i; ++k) acc = fmaf(Ls[i * kLd + k], x[k], acc);
    const float ri = rd[i];
    x[i] = i == lane ? ri : (i > lane ? -acc * ri : 0.0f);
  }
#pragma unroll
  for (int i = 0; i < kNb; ++i) Xs[i * kLd + lane] = x[i];
}

// Panel j: every block factors and inverts W_jj (warp 0), then block t forms
// rows 32 (j + 1 + t) .. + 31 of the panel, L_ij = W_ij X_jj^T, in place.
// Block 0 of an instance stores X_jj to Xd. `tiles` = max(1, blocks below).
__global__ void __launch_bounds__(128)
blocked_panel_kernel(float* __restrict__ W, float* __restrict__ Xd, int mp,
                     int j, int tiles) {
  __shared__ float Ls[kNb * kLd];
  __shared__ float Xs[kNb * kLd];
  __shared__ float Ws[kNb * kLd];
  __shared__ float rd[kNb];
  const int b = blockIdx.x / tiles;
  const int t = blockIdx.x - b * tiles;
  const int tid = threadIdx.x;
  float* Wb = W + static_cast<size_t>(b) * mp * mp;
  const int c0 = j * kNb;
  const int r0 = (j + 1 + t) * kNb;
  const bool below = r0 < mp;

  if (tid < 32) {
    // W_jj through shared memory, so the loads run along rows.
    for (int rr = 0; rr < kNb; ++rr) {
      Ls[rr * kLd + tid] = Wb[static_cast<size_t>(c0 + rr) * mp + c0 + tid];
    }
    __syncwarp();
    float a[kNb];
#pragma unroll
    for (int k = 0; k < kNb; ++k) a[k] = k <= tid ? Ls[tid * kLd + k] : 0.0f;
    __syncwarp();
    warp_factor_invert(a, tid, Ls, rd, Xs);
  } else if (below) {
    for (int e = tid - 32; e < kNb * kNb; e += 96) {
      const int r = e / kNb;
      const int k = e - r * kNb;
      Ws[r * kLd + k] = Wb[static_cast<size_t>(r0 + r) * mp + c0 + k];
    }
  }
  __syncthreads();
  if (t == 0) {
    float* Xb = Xd + (static_cast<size_t>(b) * mp + c0) * kNb;
    for (int e = tid; e < kNb * kNb; e += 128) {
      Xb[e] = Xs[(e / kNb) * kLd + (e % kNb)];
    }
  }
  if (!below) return;
  // Thread: row tid / 4, columns (tid % 4) * 8 .. + 7.
  const int r = tid >> 2;
  const int cg = (tid & 3) * 8;
  float acc[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) acc[c] = 0.0f;
#pragma unroll 8
  for (int k = 0; k < kNb; ++k) {
    const float w = Ws[r * kLd + k];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      acc[c] = fmaf(w, Xs[(cg + c) * kLd + k], acc[c]);
    }
  }
  float* dst = Wb + static_cast<size_t>(r0 + r) * mp + c0 + cg;
#pragma unroll
  for (int c = 0; c < 8; ++c) dst[c] = acc[c];
}

// Trailing update after panel j: W_ik -= L_ij L_kj^T on the 64 x 64 tiles
// on or below the diagonal of the trailing matrix (rows and columns from
// 32 (j + 1)). `T` tile rows, T (T + 1) / 2 tiles an instance.
__global__ void __launch_bounds__(256)
blocked_update_kernel(float* __restrict__ W, int mp, int j, int T) {
  __shared__ float Li[kUpd * kLd];
  __shared__ float Lk[kUpd * kLd];
  const int per = T * (T + 1) / 2;
  const int b = blockIdx.x / per;
  const int t = blockIdx.x - b * per;
  int ti = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while (ti * (ti + 1) / 2 > t) --ti;
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const int tk = t - ti * (ti + 1) / 2;
  float* Wb = W + static_cast<size_t>(b) * mp * mp;
  const int base = (j + 1) * kNb;
  const int i0 = base + ti * kUpd;
  const int k0 = base + tk * kUpd;
  const int c0 = j * kNb;
  const int tid = threadIdx.x;
  for (int e = tid; e < kUpd * kNb; e += 256) {
    const int r = e / kNb;
    const int k = e - r * kNb;
    Li[r * kLd + k] =
        i0 + r < mp ? Wb[static_cast<size_t>(i0 + r) * mp + c0 + k] : 0.0f;
    Lk[r * kLd + k] =
        k0 + r < mp ? Wb[static_cast<size_t>(k0 + r) * mp + c0 + k] : 0.0f;
  }
  __syncthreads();
  // Thread (ty, tx): rows ty + 16 a, columns tx + 16 b.
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.0f;
  }
#pragma unroll 8
  for (int k = 0; k < kNb; ++k) {
    float li[4], lk[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      li[a] = Li[(ty + 16 * a) * kLd + k];
      lk[a] = Lk[(tx + 16 * a) * kLd + k];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(li[a], lk[c], acc[a][c]);
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = i0 + ty + 16 * a;
    if (r >= mp) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = k0 + tx + 16 * c;
      if (col >= mp) continue;
      float* w = Wb + static_cast<size_t>(r) * mp + col;
      *w -= acc[a][c];
    }
  }
}

// L^-1 from the blocks of L (strictly below W's diagonal blocks) and the
// X_jj in Xd. Block (instance b, block column j, column group q): columns
// 32 j + 8 q .. + 7 of L^-1, walked down block row by block row; it writes
// zeros to the rows above block j. 8 warps; warp w reduces rows 4 w .. + 3
// of each block row along k.
__global__ void __launch_bounds__(256)
blocked_inverse_kernel(const float* __restrict__ W,
                       const float* __restrict__ Xd, float* __restrict__ out,
                       int m, int mp) {
  // Xs[c][k]: row 32 j + k, column c0 + c of X; the stride keeps the eight
  // columns of one row in distinct banks.
  __shared__ float Xs[kInvCols][kMaxM + 4];
  __shared__ float S[kNb][kInvCols + 1];
  __shared__ float Xii[kNb * kLd];
  const int nblk = mp / kNb;
  const int groups = kNb / kInvCols;
  const int per = nblk * groups;
  const int b = blockIdx.x / per;
  const int rest = blockIdx.x - b * per;
  const int j = rest / groups;
  const int c0 = j * kNb + (rest - j * groups) * kInvCols;
  if (c0 >= m) return;
  const float* Wb = W + static_cast<size_t>(b) * mp * mp;
  const float* Xb = Xd + static_cast<size_t>(b) * mp * kNb;
  float* Ob = out + static_cast<size_t>(b) * m * m;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int r = tid >> 3;              // 0 .. 31
  const int c = tid & (kInvCols - 1);  // 0 .. 7
  const bool col_ok = c0 + c < m;

  // Exact zeros above block row j.
  for (int e = tid; e < j * kNb * kInvCols; e += 256) {
    const int row = e / kInvCols;
    const int cc = e - row * kInvCols;
    if (c0 + cc < m) Ob[static_cast<size_t>(row) * m + c0 + cc] = 0.0f;
  }
  // Block row j: the slice of X_jj (zeros above its diagonal included).
  {
    const float v = Xb[static_cast<size_t>(j * kNb + r) * kNb
                       + (c0 - j * kNb) + c];
    Xs[c][r] = v;
    const int row = j * kNb + r;
    if (row < m && col_ok) Ob[static_cast<size_t>(row) * m + c0 + c] = v;
  }
  __syncthreads();

  for (int i = j + 1; i < nblk; ++i) {
    const int len = (i - j) * kNb;
    for (int e = tid; e < kNb * kNb; e += 256) {
      Xii[(e / kNb) * kLd + (e % kNb)] =
          Xb[static_cast<size_t>(i * kNb) * kNb + e];
    }
    // S = L[block row i, columns 32 j .. 32 i) * X[rows 32 j .. 32 i).
    float acc[4][kInvCols];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int q = 0; q < kInvCols; ++q) acc[a][q] = 0.0f;
    }
    const float* Lrow =
        Wb + static_cast<size_t>(i * kNb + warp * 4) * mp + j * kNb;
#pragma unroll 2
    for (int k = lane; k < len; k += 32) {
      float xv[kInvCols];
#pragma unroll
      for (int q = 0; q < kInvCols; ++q) xv[q] = Xs[q][k];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float l = Lrow[static_cast<size_t>(a) * mp + k];
#pragma unroll
        for (int q = 0; q < kInvCols; ++q) {
          acc[a][q] = fmaf(l, xv[q], acc[a][q]);
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int q = 0; q < kInvCols; ++q) {
        float v = acc[a][q];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          v += __shfl_xor_sync(kFull, v, off);
        }
        if (lane == 0) S[warp * 4 + a][q] = v;
      }
    }
    __syncthreads();
    // X_ij = -X_ii S; X_ii is lower triangular.
    float v = 0.0f;
#pragma unroll 8
    for (int k = 0; k < kNb; ++k) v = fmaf(Xii[r * kLd + k], S[k][c], v);
    v = -v;
    Xs[c][len + r] = v;
    const int row = i * kNb + r;
    if (row < m && col_ok) Ob[static_cast<size_t>(row) * m + c0 + c] = v;
    __syncthreads();
  }
}

// Enqueues the blocked path on `s`: init, then per panel the panel and the
// update kernel, then the inverse. `scratch` holds batch * mp * (mp + kNb)
// floats.
cudaError_t launch_blocked(const float* K, float* out, float* scratch,
                           int batch, int m, cudaStream_t s) {
  const int mp = (m + kNb - 1) / kNb * kNb;
  const int nblk = mp / kNb;
  float* W = scratch;
  float* Xd = scratch + static_cast<size_t>(batch) * mp * mp;
  const size_t total = static_cast<size_t>(batch) * mp * mp;
  blocked_init_kernel<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                        s>>>(K, W, m, mp, total);
  for (int j = 0; j < nblk; ++j) {
    const int below = nblk - 1 - j;
    const int tiles = below > 0 ? below : 1;
    blocked_panel_kernel<<<batch * tiles, 128, 0, s>>>(W, Xd, mp, j, tiles);
    if (below > 0) {
      const int T = (below * kNb + kUpd - 1) / kUpd;
      blocked_update_kernel<<<batch * (T * (T + 1) / 2), 256, 0, s>>>(W, mp,
                                                                      j, T);
    }
  }
  blocked_inverse_kernel<<<batch * nblk * (kNb / kInvCols), 256, 0, s>>>(
      W, Xd, out, m, mp);
  return cudaGetLastError();
}

}  // namespace

// L^-1 for `batch` row-major SPD matrices K (batch, m, m) into `out` (same
// shape, must not alias K), launched on `stream` of `device`. For m > 224
// `scratch` must hold tulip_chol_inv_scratch_floats(batch, m) floats on the
// device (the blocked path's working copy); below it is not read. Returns
// the cudaError_t of the launches (0 on success); does not synchronise.
extern "C" int tulip_chol_inv_f32(const float* K, float* out, float* scratch,
                                  int batch, int m, int device,
                                  void* stream) {
  if (batch <= 0 || m <= 0 || m > kMaxM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m > kSharedMaxM) {
    const long long mp = (m + kNb - 1) / kNb * kNb;
    // The widest grid is the init kernel's, one thread an element of W.
    if (scratch == nullptr || batch * mp * mp / 256 >= 0x7fffffffLL) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(launch_blocked(K, out, scratch, batch, m, s));
  }
  return static_cast<int>(launch_small(K, out, batch, m, 1, s));
}

// Floats of scratch that tulip_chol_inv_f32 needs at (batch, m): 0 up to
// m = 224, the padded working copy and the diagonal blocks' inverses above.
extern "C" long long tulip_chol_inv_scratch_floats(int batch, int m) {
  if (m <= kSharedMaxM) return 0;
  const long long mp = (m + kNb - 1) / kNb * kNb;
  return static_cast<long long>(batch) * mp * (mp + kNb);
}

// The packed launch: as tulip_chol_inv_f32 (`scratch` included), with up to
// `pack` instances per block. The launcher lowers pack to what fits (shared
// memory, kSmallThreads threads, the batch) and writes the count it used to `*used`; at 1 it makes the
// unpacked launch.
extern "C" int tulip_chol_inv_packed_f32(const float* K, float* out,
                                         float* scratch, int batch, int m,
                                         int pack, int device, void* stream,
                                         int* used) {
  if (batch <= 0 || m <= 0 || m > kMaxM || pack < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int max_smem = 0;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int group = small_group(m);
  int p = pack;
  if (m > kSharedMaxM) p = 1;
  p = p < kSmallThreads / group ? p : kSmallThreads / group;
  const int fit = static_cast<int>(static_cast<size_t>(max_smem) /
                                   (small_floats(m) * sizeof(float)));
  p = p < fit ? p : fit;
  p = p < batch ? p : batch;
  if (p <= 1) {
    *used = 1;
    return tulip_chol_inv_f32(K, out, scratch, batch, m, device, stream);
  }
  *used = p;
  return static_cast<int>(
      launch_small(K, out, batch, m, p, static_cast<cudaStream_t>(stream)));
}

// What the shared-memory path's launch at (m, p instances a block) gets
// from the compiler and the SM: registers a thread, local memory a thread
// in bytes (spills), and blocks resident on an SM; `*group` is the threads
// an instance. Refuses m > 224. Returns a cudaError_t.
extern "C" int tulip_chol_inv_occupancy(int m, int p, int device, int* regs,
                                        int* local_bytes, int* blocks_per_sm,
                                        int* group) {
  if (m <= 0 || m > kSharedMaxM || p <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *group = small_group(m);
  const void* fn =
      *group == 32
          ? reinterpret_cast<const void*>(chol_inv_kernel<WarpBarrier>)
          : reinterpret_cast<const void*>(chol_inv_kernel<NamedBarrier>);
  const size_t smem = small_floats(m) * sizeof(float) * p;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, p * *group, smem));
}
