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
// Above m = 224 the matrix no longer fits in shared memory, and one block
// per instance would leave the card idle at the single LP's B = 1 (one SM of
// 132 working, every rank-1 update streaming the trailing triangle through
// L2). What bounds that range is the critical path: m dependent pivots. The
// blocked path (224 < m <= 1024) keeps only the pivots serial and turns
// everything else into small tiled products spread over many blocks. With
// panels of kNb = 32 columns, on a working copy W padded to a multiple of 32
// with an identity tail (so no inner kernel masks anything):
//
//   for each panel j:
//     panel kernel   one warp of every block factors the 32 x 32 diagonal
//                    block W_jj and inverts it with the rows in registers
//                    (lane i holds row i; pivots and columns travel by
//                    __shfl_sync, no barrier), giving X_jj = L_jj^-1; the
//                    block then forms its 32 rows of the panel below as a
//                    product, L_ij = W_ij X_jj^T, so no triangular solve is
//                    on the critical path. Every block of the panel repeats
//                    the ~3 us factorization rather than wait for a launch
//                    of its own; block 0 keeps X_jj.
//     update kernel  W_ik -= L_ij L_kj^T over the 64 x 64 lower tiles of the
//                    trailing matrix, one tile per block, f32 FMA.
//   inverse kernel   L^-1 by blocks from the X_jj at hand:
//                    X_ij = -X_ii * sum_{j <= k < i} L_ik X_kj. Columns of
//                    L^-1 are independent, so each block takes 8 columns of
//                    one block column and walks down it, its slice of X in
//                    shared memory; rows of L are read along k by a warp
//                    and reduced with shuffles. It also writes the exact
//                    zeros above the diagonal.
//
// That is 2 launches a panel plus 2, all enqueued by the one C entry point
// on the caller's stream with no synchronisation; W and the X_jj live in
// scratch that the caller allocates. No tile skips work on account of its
// values, so a non-positive pivot's NaN spreads through the panel and the
// trailing products to the rest of that instance's rows, and instances never
// share a tile. m > 1024 is refused, matching the reference's routing
// (kkt/pallas_chol.py:117).
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
// makes the unpacked launch (the blocked one for m > 224).
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

__global__ void chol_inv_kernel(const float* __restrict__ K, float* out,
                                int m) {
  extern __shared__ float smem[];
  const size_t base = static_cast<size_t>(blockIdx.x) * m * m;
  shared_instance(K + base, out + base, smem, m, threadIdx.x, blockDim.x,
                  BlockBarrier{});
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

// ---------------------------------------------------------------------------
// The blocked path, 224 < m <= 1024. mp is m rounded up to a multiple of
// kNb; W is (batch, mp, mp), Xd is (batch, mp, kNb): rows 32 j .. 32 j + 31
// of Xd hold X_jj = L_jj^-1.
// ---------------------------------------------------------------------------

constexpr int kNb = 32;          // panel width: one row of a block per lane
constexpr int kLd = kNb + 1;     // shared row stride of a 32 x 32 block
constexpr int kUpd = 64;         // rows (and columns) of an update tile
constexpr int kInvCols = 8;      // columns of L^-1 per inverse block
constexpr unsigned kFull = 0xffffffffu;

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
// the rest zero) is in a[], and leaves X = L^-1 row-major in Xs (stride
// kLd, exact zeros above the diagonal). Ls (32 x kLd) and rd (32) are
// scratch. Pivots follow the unblocked kernel: r = 1 / sqrtf(p), L's column
// is the old column times r.
__device__ void warp_factor_invert(float (&a)[kNb], int lane, float* Ls,
                                   float* rd, float* Xs) {
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
  const int threads = m <= 64 ? 128 : 256;
  const size_t smem = (2 * static_cast<size_t>(m) +
                       static_cast<size_t>(m) * (m + 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(chol_inv_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chol_inv_kernel<<<batch, threads, smem, s>>>(K, out, m);
  return static_cast<int>(cudaGetLastError());
}

// Floats of scratch that tulip_chol_inv_f32 needs at (batch, m): 0 up to
// m = 224, the padded working copy and the diagonal blocks' inverses above.
extern "C" long long tulip_chol_inv_scratch_floats(int batch, int m) {
  if (m <= kSharedMaxM) return 0;
  const long long mp = (m + kNb - 1) / kNb * kNb;
  return static_cast<long long>(batch) * mp * (mp + kNb);
}

// The packed launch: as tulip_chol_inv_f32 (`scratch` included), with up to
// `pack` instances per block. The launcher lowers pack to what fits (shared memory, 1024 threads,
// 15 named barriers, the batch) and writes the count it used to `*used`;
// at 1 it makes the unpacked launch.
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
    return tulip_chol_inv_f32(K, out, scratch, batch, m, device, stream);
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
