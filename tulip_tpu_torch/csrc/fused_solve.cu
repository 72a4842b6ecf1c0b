// Fused K1 solve of the batched interior-point method, f32, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel tulip_tpu/ops/solve.py:_fused_solve_kernel
// (reached through batched_fused_k1_solve, solve.py:106), the solve stage of
// PallasSmallK1Backend(fused_solve=True). For each instance of a batch it
// takes A (m x n), Li = L^-1 with K = L L^T = A diag(d) A^T + diag(regD)
// (lower triangle read, upper ignored), d, treg = Theta^-1 + Rp, regD and
// the right-hand sides xi_p (m), xi_d (n), and returns
//
//   rhs = xi_p + A (d . xi_d);  dy = Li^T (Li rhs);  dx = d . (A^T dy - xi_d)
//
// followed by `refine` sweeps of iterative refinement on the augmented
// system: rd = xi_d - (-(treg . dx) + atdy), rp = xi_p - (A dx + regD . dy),
// the same base solve on (rp, rd), and dx, dy, atdy incremented. atdy = A^T dy
// is accumulated from each sweep's increment, never recomputed, as the TPU
// kernel does (solve.py:75-86). A lane with non-finite inputs gives
// non-finite outputs in that lane and in no other; nothing is raised.
//
// What bounds it: per instance, a chain of dependent matrix-vector products
// (A t, Li rhs, Li^T w, A^T dy, and A dx in each sweep) on m*n + m(m+1)/2
// matrix entries. At the batched solver's shapes (B = 2048, m = 48, n = 96,
// refine 1) that is ~52 MB of input against ~0.11 GFLOP, so device-memory
// bandwidth bounds it (15.6 us at 3.35 TB/s); the products are GEMVs, which
// reuse each matrix entry once per product and cannot use tensor cores.
//
// What the design does about it: one thread block per instance. When the
// instance's A, the lower triangle of Li (packed by rows) and its vectors
// fit in shared memory (the staged layout), they are staged there once, so
// device memory is read once per input and every product of every sweep
// reads shared memory; a block then holds ~27 KB at 48 x 96 and 8 blocks
// are resident per SM, which hide each other's latency. The staged body
// loads an instance in one asynchronous burst: TMA bulk copies (A's slab,
// each row of Li's lower triangle rounded up to 16 bytes, the five
// vectors), shared out over the warps, each of which waits on its own
// mbarrier; or, when a row or a base address is not 16-byte aligned,
// 4-byte cp.async copies from every thread before one wait. (A warp issues
// its bulk copies one after another, so one warp issuing them all makes
// the others wait.) Each elementwise step runs in the epilogue of the
// product that yields its input, on the thread that owns the element, and
// a sweep's two products with A (A dx and A (d . rd)) share one pass, so a
// solve with one sweep takes 8 barriers. Row products take four rows a warp
// at a time, so that one read of the vector serves four FMA chains, and
// sum them over the lanes in 6 to 10 shuffles where one butterfly a row
// would take 20 to 40.
// Above the staged layout (e.g. m = 256, n = 512), only the vectors live
// in shared memory and A and Li are read from device memory (L2) by every
// product. When the vectors do not fit either (8 of length n and 7 of
// length m in the 227 KB a block may have on an H100: n above 6,368 at
// m = 1,024), the m-long ones stay in shared memory and the n-long ones in
// device memory: the inputs and dx in place, four more in a workspace of
// 4 n floats per instance that the caller allocates. So every n is taken.
// Row products (A x, Li x) give a warp to a row, lanes along the row;
// column products (A^T y, Li^T w) give a thread to a column, so
// neighbouring threads read neighbouring addresses of a row in both
// layouts. f32 FMA only: no TF32, no fast-math. Elementwise steps round
// each product before the following add (__fmul_rn), as the plain PyTorch
// version's separate operations do. The staged body's output does not
// depend on which copies loaded it or on its number of threads: each value
// comes from the same IEEE operations in the same order.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

// For diagnosis only (time_kernels.py --leave-out): a build with
// -DFUSED_LEAVE_OUT=1 drops the staged layout's loads, 2 its row products,
// 3 its column products, 4 its refinement sweeps. Its output is wrong;
// only its time means anything.
#ifndef FUSED_LEAVE_OUT
#define FUSED_LEAVE_OUT 0
#endif

// Threads an instance of the staged layout; 0 picks them by m. Other
// counts are for timing builds (time_kernels.py --threads).
#ifndef FUSED_THREADS
#define FUSED_THREADS 0
#endif

namespace {

constexpr int kMaxM = 1024;

// Vectors per instance of the streamed and wide layouts (and of the bound
// of the staged one): 8 of length n, 7 of length m; 4 of the n-long ones
// are scratch, in the workspace when the n-long vectors live in device
// memory.
constexpr int kVecN = 8;
constexpr int kVecM = 7;
constexpr int kWorkN = 4;

// The staged body keeps 7 n-long and 6 m-long vectors (rp and a sweep's
// atdy increment live in registers), and an mbarrier a warp in 16 floats.
constexpr int kStagedVecN = 7;
constexpr int kStagedVecM = 6;
constexpr int kStagedMaxThreads = 256;
constexpr int kBarFloats = 2 * kStagedMaxThreads / 32;
// Rows a warp takes at a time in the staged body's row products.
constexpr int kRowsAtOnce = 4;

// Where an instance's data lives: all of it in shared memory; the vectors
// there and A, Li in device memory; or only the m-long vectors there.
enum Layout { kStaged = 2, kStreamed = 1, kWide = 0 };
// What *layout reports for a staged launch whose loads were bulk copies.
constexpr int kStagedBulk = 3;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// y[i] = sum_j A[i][j] x[j] (+ add[i] when add is given): a warp per row.
__device__ void a_times(const float* A, const float* x, const float* add,
                        float* y, int m, int n) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < m; i += nwarps) {
    const float* row = A + static_cast<size_t>(i) * n;
    float acc = 0.0f;
    for (int j = lane; j < n; j += 32) acc = fmaf(row[j], x[j], acc);
    acc = warp_sum(acc);
    if (lane == 0) y[i] = add ? acc + add[i] : acc;
  }
}

// Column products keep kAcc partial sums, row i going to partial i mod kAcc
// (the rows past the last multiple of kAcc to partial 0), added pairwise at
// the end. One serial sum of m terms has a rounding error that grows with m,
// and the factor's conditioning amplifies it; kAcc independent chains also
// hide the FMA latency.
constexpr int kAcc = 8;

__device__ __forceinline__ float pairwise(const float (&a)[kAcc]) {
  return ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
}

// y[j] = sum_i A[i][j] x[i]: a thread per column.
__device__ void at_times(const float* A, const float* x, float* y, int m,
                         int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float acc[kAcc] = {};
    int i = 0;
    for (; i + kAcc <= m; i += kAcc) {
#pragma unroll
      for (int k = 0; k < kAcc; ++k) {
        acc[k] = fmaf(A[static_cast<size_t>(i + k) * n + j], x[i + k], acc[k]);
      }
    }
    for (; i < m; ++i) {
      acc[0] = fmaf(A[static_cast<size_t>(i) * n + j], x[i], acc[0]);
    }
    y[j] = pairwise(acc);
  }
}

// y[i] = sum_{j <= i} Li[i][j] x[j]: a warp per row, Li in full rows.
__device__ void li_times(const float* L, const float* x, float* y, int m) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < m; i += nwarps) {
    const float* row = L + static_cast<size_t>(i) * m;
    float acc = 0.0f;
    for (int j = lane; j <= i; j += 32) acc = fmaf(row[j], x[j], acc);
    acc = warp_sum(acc);
    if (lane == 0) y[i] = acc;
  }
}

// y[j] = sum_{i >= j} Li[i][j] x[i]: a thread per column, Li in full rows.
// The threads of a warp walk the rows together from the warp's first
// column, so each step reads one row at neighbouring addresses; a thread
// adds only rows i >= j.
__device__ void lit_times(const float* L, const float* x, float* y, int m) {
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    float acc[kAcc] = {};
    int i = j & ~31;
    for (; i + kAcc <= m; i += kAcc) {
#pragma unroll
      for (int k = 0; k < kAcc; ++k) {
        if (i + k >= j) {
          acc[k] = fmaf(L[static_cast<size_t>(i + k) * m + j], x[i + k],
                        acc[k]);
        }
      }
    }
    for (; i < m; ++i) {
      if (i >= j) {
        acc[0] = fmaf(L[static_cast<size_t>(i) * m + j], x[i], acc[0]);
      }
    }
    y[j] = pairwise(acc);
  }
}

// One base solve on (p, q): x = d . (A^T y - q), y = Li^T Li (A (d . q) + p),
// z = A^T y. T (n), R and W (m) are scratch; x may alias T.
__device__ void base_solve(const float* A, const float* L, const float* d,
                           const float* p, const float* q, float* x, float* y,
                           float* z, float* T, float* R, float* W, int m,
                           int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) T[j] = d[j] * q[j];
  __syncthreads();
  a_times(A, T, p, R, m, n);
  __syncthreads();
  li_times(L, R, W, m);
  __syncthreads();
  lit_times(L, W, y, m);
  __syncthreads();
  at_times(A, y, z, m, n);
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) x[j] = d[j] * (z[j] - q[j]);
  __syncthreads();
}

// The streamed and wide layouts: A and Li read from device memory, the
// vectors in shared memory (kVecs) or the n-long ones in device memory.
template <bool kVecs>
__global__ void __launch_bounds__(1024)
    fused_solve_kernel(const float* __restrict__ A, const float* __restrict__ Li,
                       const float* __restrict__ d, const float* __restrict__ treg,
                       const float* __restrict__ regD,
                       const float* __restrict__ xip,
                       const float* __restrict__ xid, float* __restrict__ dx,
                       float* __restrict__ dy, float* work, int m, int n,
                       int refine) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const size_t b = blockIdx.x;

  // n-long vectors: copies in shared memory (kVecs), else the inputs and dx
  // in place and the scratch ones in this instance's workspace.
  if (kVecs) {
    for (int j = tid; j < n; j += nt) {
      smem[j] = d[b * n + j];
      smem[n + j] = treg[b * n + j];
      smem[2 * n + j] = xid[b * n + j];
    }
  }
  const float* vd = kVecs ? smem : d + b * n;              // d
  const float* vtr = kVecs ? smem + n : treg + b * n;      // treg
  const float* vxd = kVecs ? smem + 2 * n : xid + b * n;   // xi_d
  float* DX = kVecs ? smem + 3 * n : dx + b * n;           // dx
  float* wk = kVecs ? smem + 4 * n : work + b * kWorkN * n;
  float* AT = wk;          // atdy = A^T dy
  float* Q = AT + n;       // rd
  float* T = Q + n;        // d . q, then a sweep's dx increment
  float* Z = T + n;        // a sweep's atdy increment
  float* vxp = kVecs ? smem + kVecN * n : smem;  // xi_p
  float* vrg = vxp + m;    // regD
  float* DY = vrg + m;     // dy
  float* P = DY + m;       // rp
  float* R = P + m;        // rhs, A dx
  float* W = R + m;        // Li rhs
  float* Y = W + m;        // a sweep's dy increment

  const float* Am = A + b * m * n;
  const float* Lm = Li + b * m * m;
  for (int i = tid; i < m; i += nt) {
    vxp[i] = xip[b * m + i];
    vrg[i] = regD[b * m + i];
  }
  __syncthreads();

  base_solve(Am, Lm, vd, vxp, vxd, DX, DY, AT, T, R, W, m, n);

  for (int r = 0; r < refine; ++r) {
    for (int j = tid; j < n; j += nt) {
      Q[j] = vxd[j] - (-__fmul_rn(vtr[j], DX[j]) + AT[j]);
    }
    a_times(Am, DX, nullptr, R, m, n);
    __syncthreads();
    for (int i = tid; i < m; i += nt) {
      P[i] = vxp[i] - (R[i] + __fmul_rn(vrg[i], DY[i]));
    }
    __syncthreads();
    base_solve(Am, Lm, vd, P, Q, T, Y, Z, T, R, W, m, n);
    for (int j = tid; j < n; j += nt) {
      DX[j] += T[j];
      AT[j] += Z[j];
    }
    for (int i = tid; i < m; i += nt) DY[i] += Y[i];
    __syncthreads();
  }

  if (kVecs) {
    for (int j = tid; j < n; j += nt) dx[b * n + j] = DX[j];
  }
  for (int i = tid; i < m; i += nt) dy[b * m + i] = DY[i];
}

// ---------------------------------------------------------------------------
// The staged layout.

// Offset of row i in Li's lower triangle packed by rows: row i at
// i(i+1)/2, or, kPadded, with each row rounded up to a multiple of 4
// floats so that every row starts on 16 bytes.
template <bool kPadded>
__host__ __device__ __forceinline__ size_t li_off(int i) {
  if (!kPadded) return static_cast<size_t>(i) * (i + 1) / 2;
  const size_t g = i >> 2;
  return 4 * (g + 1) * (2 * g + (i & 3));
}

// x[0 .. kAcc - 1], by two 16-byte loads when kVec4 (x on 16 bytes).
template <bool kVec4>
__device__ __forceinline__ void load_acc(const float* x, float (&v)[kAcc]) {
  if (kVec4) {
    const float4 a = reinterpret_cast<const float4*>(x)[0];
    const float4 b = reinterpret_cast<const float4*>(x)[1];
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < kAcc; ++k) v[k] = x[k];
  }
}

// The staged body's column products: at_times' and lit_times' sums (the
// same partials in the same order), handed to epi(j, sum) on the thread
// that owns column j. Two steps of 8 rows are unrolled so that their loads
// overlap, and with kVec4 (x on 16 bytes) a step reads its 8 entries of x
// as two float4.
template <bool kVec4, class Epi>
__device__ __forceinline__ void at_cols(const float* A, const float* x,
                                        int m, int n, Epi epi) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float acc[kAcc] = {};
    int i = FUSED_LEAVE_OUT == 3 ? m : 0;
#pragma unroll 2
    for (; i + kAcc <= m; i += kAcc) {
      float xv[kAcc];
      load_acc<kVec4>(x + i, xv);
#pragma unroll
      for (int k = 0; k < kAcc; ++k) {
        acc[k] = fmaf(A[static_cast<size_t>(i + k) * n + j], xv[k], acc[k]);
      }
    }
    for (; i < m; ++i) {
      acc[0] = fmaf(A[static_cast<size_t>(i) * n + j], x[i], acc[0]);
    }
    epi(j, pairwise(acc));
  }
}

// Li^T x with Li packed by rows (padded when kPadded).
template <bool kPadded, bool kVec4, class Epi>
__device__ __forceinline__ void lit_cols(const float* L, const float* x,
                                         int m, Epi epi) {
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    float acc[kAcc] = {};
    int i = FUSED_LEAVE_OUT == 3 ? m : j & ~31;
#pragma unroll 2
    for (; i + kAcc <= m; i += kAcc) {
      float xv[kAcc];
      load_acc<kVec4>(x + i, xv);
#pragma unroll
      for (int k = 0; k < kAcc; ++k) {
        if (i + k >= j) {
          acc[k] = fmaf(L[li_off<kPadded>(i + k) + j], xv[k], acc[k]);
        }
      }
    }
    for (; i < m; ++i) {
      if (i >= j) acc[0] = fmaf(L[li_off<kPadded>(i) + j], x[i], acc[0]);
    }
    epi(j, pairwise(acc));
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// `bytes` (a multiple of 16) from `src` to `dst` (both 16-byte aligned) by
// the TMA unit, counted on the mbarrier at shared address `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One float from `src` to `dst`, asynchronously (LDGSTS).
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

// Waits until the mbarrier at shared address `bar` completes the phase of
// `parity`. A wait that has not completed after 2^24 polls (a miscounted
// transfer) traps, so that the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 24)) __trap();
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// Bytes of copy k of an instance's bulk load: row k of Li's lower triangle
// (its first 4 ceil((k+1)/4) floats) for k < m, then A's slab, then d,
// treg, xi_d, xi_p and regD.
__device__ __forceinline__ uint32_t bulk_bytes(int k, int m, int n) {
  if (k < m) return 16u * ((k >> 2) + 1);
  if (k == m) return 4u * static_cast<uint32_t>(m) * n;
  return 4u * (k - m - 1 < 3 ? n : m);
}

// Every warp loads its share of an instance with bulk copies and waits for
// them on its own mbarrier (bars + 8 w bytes for warp w): of the m + 6
// copies, copy k goes to lane k / w of warp k % w, w warps in all, so the
// warps issue them side by side. Lane 0 sets up the warp's mbarrier with
// the bytes of the warp's copies before any is issued.
__device__ void stage_bulk(float* bars, float* sA, float* sL, float* vd,
                           float* vtr, float* vxd, float* vxp, float* vrg,
                           const float* Ab, const float* Lb, const float* d,
                           const float* treg, const float* xid,
                           const float* xip, const float* regD, int m,
                           int n) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const uint32_t bar = smem_u32(bars) + 8 * warp;
  uint32_t bytes = 0;
  for (int k = warp + nw * lane; k < m + 6; k += 32 * nw) {
    bytes += bulk_bytes(k, m, n);
  }
  bytes = __reduce_add_sync(0xffffffffu, bytes);
  if (bytes == 0) return;
  if (lane == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                     "r"(bar), "r"(bytes)
                 : "memory");
  }
  __syncwarp();
  for (int k = warp + nw * lane; k < m + 6; k += 32 * nw) {
    float* dst;
    const float* src;
    if (k < m) {
      dst = sL + li_off<true>(k);
      src = Lb + static_cast<size_t>(k) * m;
    } else if (k == m) {
      dst = sA;
      src = Ab;
    } else {
      const int v = k - m - 1;
      dst = v == 0 ? vd : v == 1 ? vtr : v == 2 ? vxd : v == 3 ? vxp : vrg;
      src = v == 0 ? d : v == 1 ? treg : v == 2 ? xid : v == 3 ? xip : regD;
    }
    bulk_copy(dst, src, bulk_bytes(k, m, n), bar);
  }
  mbar_wait(bar, 0);
}

// Every thread copies its share of an instance one float at a time
// (cp.async, 4 bytes), then waits for its own copies.
__device__ void stage_lanes(float* sA, float* sL, float* vd, float* vtr,
                            float* vxd, float* vxp, float* vrg,
                            const float* Ab, const float* Lb, const float* d,
                            const float* treg, const float* xid,
                            const float* xip, const float* regD, int m,
                            int n) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  for (int e = tid; e < m * n; e += nt) copy4(sA + e, Ab + e);
  for (int i = tid >> 5; i < m; i += nt >> 5) {
    for (int j = lane; j <= i; j += 32) {
      copy4(sL + li_off<false>(i) + j,
            Lb + static_cast<size_t>(i) * m + j);
    }
  }
  for (int j = tid; j < n; j += nt) {
    copy4(vd + j, d + j);
    copy4(vtr + j, treg + j);
    copy4(vxd + j, xid + j);
  }
  for (int i = tid; i < m; i += nt) {
    copy4(vxp + i, xip + i);
    copy4(vrg + i, regD + i);
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// Totals of kQ values (a power of 2 up to 32) over the 32 lanes of a warp,
// each by the xor butterfly of warp_sum (partners 16, 8, 4, 2, 1), in
// fewer shuffles: at each of the first log2(kQ) steps a lane keeps one half
// of its values (the upper half when its bit o is set) and trades the other
// half with its partner, which keeps that half. Every addition adds the
// same two partial sums as warp_sum's, so each total is warp_sum's bit for
// bit. Lane l ends with the total of value l / (32 / kQ).
template <int kQ>
__device__ __forceinline__ float warp_sums(float (&v)[kQ]) {
  const int lane = threadIdx.x & 31;
  int o = 16;
#pragma unroll
  for (int h = kQ / 2; h >= 1; h /= 2, o /= 2) {
    const bool upper = lane & o;
#pragma unroll
    for (int q = 0; q < h; ++q) {
      const float own = upper ? v[q + h] : v[q];
      const float give = upper ? v[q] : v[q + h];
      v[q] = own + __shfl_xor_sync(0xffffffffu, give, o);
    }
  }
  for (; o > 0; o /= 2) v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  return v[0];
}

// Row products of the staged body: for each row i < m of M (row(i) its
// first entry, i + 1 entries when kTri, else n), the dot products
// s[v] = sum_j M[i][j] x_v[j] with kV vectors, xs(j, x) giving their j-th
// entries. Each is one FMA chain a lane along the row (j = lane, lane + 32,
// ...) and then the xor butterfly, as a_times and li_times sum. A warp
// takes kRowsAtOnce consecutive rows at a time, so that each x read serves
// all of them and their chains overlap; rows past m of the last group
// repeat row m - 1 and are dropped. epi(i, s) runs on one lane a row.
template <int kV, bool kTri, class Row, class Xs, class Epi>
__device__ __forceinline__ void row_dots(int m, int n, Row row, Xs xs,
                                         Epi epi) {
  constexpr int kR = kRowsAtOnce;
  constexpr int kQ = kR * kV;
  const int lane = threadIdx.x & 31;
  const int step = (blockDim.x >> 5) * kR;
  for (int i0 = (threadIdx.x >> 5) * kR; i0 < m; i0 += step) {
    const float* r[kR];
#pragma unroll
    for (int k = 0; k < kR; ++k) r[k] = row(min(i0 + k, m - 1));
    const int end = kTri ? min(i0 + kR, m) : n;
    float s[kQ] = {};  // row k, vector v at k * kV + v
    for (int j = lane; FUSED_LEAVE_OUT != 2 && j < end; j += 32) {
      float x[kV];
      xs(j, x);
#pragma unroll
      for (int k = 0; k < kR; ++k) {
        if (!kTri || j <= i0 + k) {
#pragma unroll
          for (int v = 0; v < kV; ++v) {
            s[k * kV + v] = fmaf(r[k][j], x[v], s[k * kV + v]);
          }
        }
      }
    }
    // Lane l holds value l / (32 / kQ): row k's kV values sit on the lanes
    // from k * 32 / kR, kV apart by 32 / kQ.
    float got[kV];
    got[0] = warp_sums(s);
#pragma unroll
    for (int v = 1; v < kV; ++v) {
      got[v] = __shfl_down_sync(0xffffffffu, got[0], v * (32 / kQ));
    }
    const int k = lane / (32 / kR);
    if (lane % (32 / kR) == 0 && i0 + k < m) epi(i0 + k, got);
  }
}

// The staged layout: the instance in shared memory, loaded by bulk copies
// (kBulk: m and n multiples of 4, every input 16-byte aligned) or by 4-byte
// copies. Base solve: rhs = xi_p + A (d . xi_d) (the product d . xi_d
// formed as A's rows read it), W = Li rhs, dy = Li^T W, then atdy = A^T dy
// with dx = d . (atdy - xi_d), rd and d . rd in its epilogue. A sweep:
// rp = xi_p - (A dx + regD . dy) and rhs = A (d . rd) + rp in one pass over
// A, W = Li rhs, the dy increment Li^T W added to dy in its epilogue, and
// A^T of it, whose epilogue adds the dx and atdy increments and forms the
// next sweep's rd and d . rd. The last epilogues write dx and dy.
template <bool kBulk>
__global__ void __launch_bounds__(kStagedMaxThreads, 4)
    staged_solve_kernel(const float* __restrict__ A,
                        const float* __restrict__ Li,
                        const float* __restrict__ d,
                        const float* __restrict__ treg,
                        const float* __restrict__ regD,
                        const float* __restrict__ xip,
                        const float* __restrict__ xid, float* __restrict__ dx,
                        float* __restrict__ dy, int m, int n, int refine) {
  extern __shared__ __align__(16) float staged_smem[];
  float* smem = staged_smem;
  const size_t b = blockIdx.x;
  float* sA = smem + kBarFloats;
  float* sL = sA + static_cast<size_t>(m) * n;
  float* vd = sL + li_off<kBulk>(m);  // d
  float* vtr = vd + n;    // treg
  float* vxd = vtr + n;   // xi_d
  float* DX = vxd + n;    // dx
  float* AT = DX + n;     // atdy = A^T dy
  float* Q = AT + n;      // rd
  float* T = Q + n;       // d . rd
  float* vxp = T + n;     // xi_p
  float* vrg = vxp + m;   // regD
  float* DY = vrg + m;    // dy
  float* R = DY + m;      // rhs
  float* W = R + m;       // Li rhs
  float* Y = W + m;       // a sweep's dy increment
  const float* Ab = A + b * m * n;
  const float* Lb = Li + b * m * m;

  if (FUSED_LEAVE_OUT != 1) {
    if (!kBulk) {
      stage_lanes(sA, sL, vd, vtr, vxd, vxp, vrg, Ab, Lb, d + b * n,
                  treg + b * n, xid + b * n, xip + b * m, regD + b * m, m, n);
    } else {
      stage_bulk(smem, sA, sL, vd, vtr, vxd, vxp, vrg, Ab, Lb, d + b * n,
                 treg + b * n, xid + b * n, xip + b * m, regD + b * m, m, n);
    }
  }
  __syncthreads();

  const int sweeps = FUSED_LEAVE_OUT == 4 ? 0 : refine;
  auto a_row = [=](int i) { return sA + static_cast<size_t>(i) * n; };
  auto l_row = [=](int i) { return sL + li_off<kBulk>(i); };
  auto w_is = [=](int i, const float (&s)[1]) { W[i] = s[0]; };
  auto r_at = [=](int j, float (&x)[1]) { x[0] = R[j]; };

  row_dots<1, false>(
      m, n, a_row,
      [=](int j, float (&x)[1]) { x[0] = __fmul_rn(vd[j], vxd[j]); },
      [=](int i, const float (&s)[1]) { R[i] = s[0] + vxp[i]; });
  __syncthreads();
  row_dots<1, true>(m, m, l_row, r_at, w_is);
  __syncthreads();
  lit_cols<kBulk, kBulk>(sL, W, m, [=](int j, float y) {
    DY[j] = y;
    if (sweeps == 0) dy[b * m + j] = y;
  });
  __syncthreads();
  at_cols<kBulk>(sA, DY, m, n, [=](int j, float z) {
    const float x = vd[j] * (z - vxd[j]);
    if (sweeps == 0) {
      dx[b * n + j] = x;
      return;
    }
    DX[j] = x;
    AT[j] = z;
    const float q = vxd[j] - (-__fmul_rn(vtr[j], x) + z);
    Q[j] = q;
    T[j] = vd[j] * q;
  });

  for (int r = 0; r < sweeps; ++r) {
    const bool last = r + 1 == sweeps;
    __syncthreads();
    row_dots<2, false>(
        m, n, a_row,
        [=](int j, float (&x)[2]) {
          x[0] = DX[j];
          x[1] = T[j];
        },
        [=](int i, const float (&s)[2]) {
          const float p = vxp[i] - (s[0] + __fmul_rn(vrg[i], DY[i]));
          R[i] = s[1] + p;
        });
    __syncthreads();
    row_dots<1, true>(m, m, l_row, r_at, w_is);
    __syncthreads();
    lit_cols<kBulk, kBulk>(sL, W, m, [=](int j, float y) {
      Y[j] = y;
      const float v = DY[j] + y;
      DY[j] = v;
      if (last) dy[b * m + j] = v;
    });
    __syncthreads();
    at_cols<kBulk>(sA, Y, m, n, [=](int j, float z) {
      const float x = DX[j] + __fmul_rn(vd[j], z - Q[j]);
      if (last) {
        dx[b * n + j] = x;
        return;
      }
      const float at = AT[j] + z;
      DX[j] = x;
      AT[j] = at;
      const float q = vxd[j] - (-__fmul_rn(vtr[j], x) + at);
      Q[j] = q;
      T[j] = vd[j] * q;
    });
  }
}

// Layout of an instance and the streamed and wide layouts' shared memory
// in bytes, for a card whose blocks may opt in to `max_smem` bytes.
Layout plan(int m, int n, size_t max_smem, size_t* smem) {
  const size_t vec = (static_cast<size_t>(kVecN) * n +
                      static_cast<size_t>(kVecM) * m) * sizeof(float);
  const size_t mats = (static_cast<size_t>(m) * n +
                       static_cast<size_t>(m) * (m + 1) / 2) * sizeof(float);
  if (vec + mats <= max_smem) {
    *smem = vec + mats;
    return kStaged;
  }
  if (vec <= max_smem) {
    *smem = vec;
    return kStreamed;
  }
  *smem = static_cast<size_t>(kVecM) * m * sizeof(float);
  return kWide;
}

// Shared memory of the staged body in bytes; with bulk copies Li's rows
// are padded. At most plan()'s bytes without them (n + m >= 16).
size_t staged_bytes(int m, int n, bool bulk) {
  const size_t tri =
      bulk ? li_off<true>(m) : li_off<false>(m);
  return (kBarFloats + static_cast<size_t>(m) * n + tri +
          static_cast<size_t>(kStagedVecN) * n +
          static_cast<size_t>(kStagedVecM) * m) * sizeof(float);
}

int staged_threads(int m) {
  return FUSED_THREADS ? FUSED_THREADS : (m <= 64 ? 128 : 256);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether a staged (m, n) solve may load by bulk copies: rows of A and Li
// and the vectors of each instance start on 16 bytes, and the padded rows
// fit.
bool bulk_fits(int m, int n, size_t max_smem) {
  return m % 4 == 0 && n % 4 == 0 && staged_bytes(m, n, true) <= max_smem;
}

const void* staged_fn(bool bulk) {
  return bulk ? reinterpret_cast<const void*>(staged_solve_kernel<true>)
              : reinterpret_cast<const void*>(staged_solve_kernel<false>);
}

cudaError_t allow_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool kVecs>
cudaError_t launch(const float* A, const float* Li, const float* d,
                   const float* treg, const float* regD, const float* xip,
                   const float* xid, float* dx, float* dy, float* work,
                   int batch, int m, int n, int refine, size_t smem,
                   cudaStream_t s) {
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(fused_solve_kernel<kVecs>), smem);
  if (err != cudaSuccess) return err;
  fused_solve_kernel<kVecs><<<batch, 1024, smem, s>>>(
      A, Li, d, treg, regD, xip, xid, dx, dy, work, m, n, refine);
  return cudaGetLastError();
}

cudaError_t launch_staged(bool bulk, const float* A, const float* Li,
                          const float* d, const float* treg,
                          const float* regD, const float* xip,
                          const float* xid, float* dx, float* dy, int batch,
                          int m, int n, int refine, cudaStream_t s) {
  const size_t smem = staged_bytes(m, n, bulk);
  cudaError_t err = allow_smem(staged_fn(bulk), smem);
  if (err != cudaSuccess) return err;
  const int threads = staged_threads(m);
  if (bulk) {
    staged_solve_kernel<true><<<batch, threads, smem, s>>>(
        A, Li, d, treg, regD, xip, xid, dx, dy, m, n, refine);
  } else {
    staged_solve_kernel<false><<<batch, threads, smem, s>>>(
        A, Li, d, treg, regD, xip, xid, dx, dy, m, n, refine);
  }
  return cudaGetLastError();
}

cudaError_t max_smem_of(int device, size_t* out) {
  int v = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  *out = static_cast<size_t>(v);
  return err;
}

}  // namespace

// Floats of device-memory workspace that each instance of an (m, n) solve
// needs on `device`: 4 n when its n-long vectors do not fit in shared
// memory, else 0. Returns the cudaError_t of the query.
extern "C" int tulip_fused_k1_solve_workspace(int m, int n, int device,
                                              long long* floats) {
  if (m <= 0 || m > kMaxM || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t max_smem = 0;
  const cudaError_t err = max_smem_of(device, &max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t smem = 0;
  *floats = plan(m, n, max_smem, &smem) == kWide
                ? static_cast<long long>(kWorkN) * n
                : 0;
  return 0;
}

// The staged body's launch at (m, n) on `device`, loaded by bulk copies
// (`bulk` != 0) or by 4-byte copies: registers and bytes of local memory a
// thread, instances resident on an SM and threads an instance. Returns
// cudaErrorInvalidValue when (m, n) does not take the staged layout, or
// not with bulk copies when `bulk` asks for them.
extern "C" int tulip_fused_k1_solve_occupancy(int m, int n, int bulk,
                                              int device, int* regs,
                                              int* local_bytes,
                                              int* blocks_per_sm,
                                              int* threads) {
  if (m <= 0 || m > kMaxM || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t max_smem = 0;
  err = max_smem_of(device, &max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t smem = 0;
  if (plan(m, n, max_smem, &smem) != kStaged ||
      (bulk && !bulk_fits(m, n, max_smem))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fn = staged_fn(bulk);
  smem = staged_bytes(m, n, bulk);
  err = allow_smem(fn, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *local_bytes = static_cast<int>(attr.localSizeBytes);
  *threads = staged_threads(m);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, fn, *threads, smem));
}

// Solve `batch` instances (row-major A (batch, m, n), Li (batch, m, m),
// d/treg/xid (batch, n), regD/xip (batch, m)) into dx (batch, n) and dy
// (batch, m), launched on `stream` of `device`. `work` holds the floats
// that tulip_fused_k1_solve_workspace asks for, times `batch` (may be null
// when that is 0). Outputs must not alias inputs or `work`. `*layout` is set
// to 3 when A and Li were staged in shared memory by bulk copies (m and n
// multiples of 4 and every input 16-byte aligned), 2 when they were staged
// by 4-byte copies, 1 when they were read from device memory, 0 when the
// n-long vectors were too. Returns the cudaError_t of the launch (0 on
// success); does not synchronise.
extern "C" int tulip_fused_k1_solve_f32(const float* A, const float* Li,
                                        const float* d, const float* treg,
                                        const float* regD, const float* xip,
                                        const float* xid, float* dx, float* dy,
                                        float* work, int batch, int m, int n,
                                        int refine, int device, void* stream,
                                        int* layout) {
  if (batch <= 0 || m <= 0 || m > kMaxM || n <= 0 || refine < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t max_smem = 0;
  err = max_smem_of(device, &max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  size_t smem = 0;
  const Layout how = plan(m, n, max_smem, &smem);
  if (smem > max_smem || (how == kWide && work == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (how == kStaged) {
    const bool bulk = bulk_fits(m, n, max_smem) && aligned16(A) &&
                      aligned16(Li) && aligned16(d) && aligned16(treg) &&
                      aligned16(regD) && aligned16(xip) && aligned16(xid);
    err = launch_staged(bulk, A, Li, d, treg, regD, xip, xid, dx, dy, batch,
                        m, n, refine, s);
    *layout = bulk ? kStagedBulk : static_cast<int>(kStaged);
  } else {
    err = how == kStreamed
              ? launch<true>(A, Li, d, treg, regD, xip, xid, dx, dy, work,
                             batch, m, n, refine, smem, s)
              : launch<false>(A, Li, d, treg, regD, xip, xid, dx, dy, work,
                              batch, m, n, refine, smem, s);
    *layout = static_cast<int>(how);
  }
  return static_cast<int>(err);
}
