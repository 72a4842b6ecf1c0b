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
// fit in shared memory, they are staged there once, so device memory is
// read once per input and every product of every sweep reads shared memory;
// a block then holds ~27 KB at 48 x 96 and 8 blocks are resident per SM.
// Above that (e.g. m = 256, n = 512), only the vectors live in shared memory
// and A and Li are read from device memory (L2) by every product. When the
// vectors do not fit either (8 of length n and 7 of length m in the 227 KB
// a block may have on an H100: n above 6,368 at m = 1,024), the m-long
// ones stay in shared memory and the n-long ones in device memory: the
// inputs and dx in place, four more in a workspace of 4 n floats per
// instance that the caller allocates. So every n is taken. Row
// products (A x, Li x) give a warp to a row, lanes along the row; column
// products (A^T y, Li^T w) give a thread to a column, so neighbouring
// threads read neighbouring addresses of a row in both layouts. f32 FMA
// only: no TF32, no fast-math. Elementwise steps round each product before
// the following add (__fmul_rn), as the plain PyTorch version's separate
// operations do.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kMaxM = 1024;

// Vectors per instance: 8 of length n, 7 of length m; 4 of the n-long ones
// are scratch, in the workspace when the n-long vectors live in device
// memory.
constexpr int kVecN = 8;
constexpr int kVecM = 7;
constexpr int kWorkN = 4;

// Where an instance's data lives: all of it in shared memory; the vectors
// there and A, Li in device memory; or only the m-long vectors there.
enum Layout { kStaged = 2, kStreamed = 1, kWide = 0 };

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Row i of Li: packed lower rows in shared memory (row i at i(i+1)/2), full
// m-float rows in device memory.
template <bool kShared>
__device__ __forceinline__ const float* li_row(const float* L, int i, int m) {
  return kShared ? L + (i * (i + 1)) / 2 : L + static_cast<size_t>(i) * m;
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

// y[i] = sum_{j <= i} Li[i][j] x[j]: a warp per row.
template <bool kShared>
__device__ void li_times(const float* L, const float* x, float* y, int m) {
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < m; i += nwarps) {
    const float* row = li_row<kShared>(L, i, m);
    float acc = 0.0f;
    for (int j = lane; j <= i; j += 32) acc = fmaf(row[j], x[j], acc);
    acc = warp_sum(acc);
    if (lane == 0) y[i] = acc;
  }
}

// y[j] = sum_{i >= j} Li[i][j] x[i]: a thread per column. The threads of a
// warp walk the rows together from the warp's first column, so each step
// reads one row at neighbouring addresses; a thread adds only rows i >= j.
template <bool kShared>
__device__ void lit_times(const float* L, const float* x, float* y, int m) {
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    float acc[kAcc] = {};
    int i = j & ~31;
    for (; i + kAcc <= m; i += kAcc) {
#pragma unroll
      for (int k = 0; k < kAcc; ++k) {
        if (i + k >= j) {
          acc[k] = fmaf(li_row<kShared>(L, i + k, m)[j], x[i + k], acc[k]);
        }
      }
    }
    for (; i < m; ++i) {
      if (i >= j) acc[0] = fmaf(li_row<kShared>(L, i, m)[j], x[i], acc[0]);
    }
    y[j] = pairwise(acc);
  }
}

// One base solve on (p, q): x = d . (A^T y - q), y = Li^T Li (A (d . q) + p),
// z = A^T y. T (n), R and W (m) are scratch; x may alias T.
template <bool kShared>
__device__ void base_solve(const float* A, const float* L, const float* d,
                           const float* p, const float* q, float* x, float* y,
                           float* z, float* T, float* R, float* W, int m,
                           int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) T[j] = d[j] * q[j];
  __syncthreads();
  a_times(A, T, p, R, m, n);
  __syncthreads();
  li_times<kShared>(L, R, W, m);
  __syncthreads();
  lit_times<kShared>(L, W, y, m);
  __syncthreads();
  at_times(A, y, z, m, n);
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) x[j] = d[j] * (z[j] - q[j]);
  __syncthreads();
}

template <bool kShared, bool kVecs>
__global__ void __launch_bounds__(kShared ? 256 : 1024)
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

  const float* Ab = A + b * m * n;
  const float* Lb = Li + b * m * m;
  const float* Am = Ab;
  const float* Lm = Lb;
  if (kShared) {
    float* sA = Y + m;
    float* sL = sA + static_cast<size_t>(m) * n;
    for (int e = tid; e < m * n; e += nt) sA[e] = Ab[e];
    const int lane = tid & 31;
    for (int i = tid >> 5; i < m; i += nt >> 5) {
      for (int j = lane; j <= i; j += 32) sL[(i * (i + 1)) / 2 + j] = Lb[i * m + j];
    }
    Am = sA;
    Lm = sL;
  }
  for (int i = tid; i < m; i += nt) {
    vxp[i] = xip[b * m + i];
    vrg[i] = regD[b * m + i];
  }
  __syncthreads();

  base_solve<kShared>(Am, Lm, vd, vxp, vxd, DX, DY, AT, T, R, W, m, n);

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
    base_solve<kShared>(Am, Lm, vd, P, Q, T, Y, Z, T, R, W, m, n);
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

// Layout of an instance and its shared memory in bytes, for a card whose
// blocks may opt in to `max_smem` bytes.
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

template <bool kShared, bool kVecs>
cudaError_t launch(const float* A, const float* Li, const float* d,
                   const float* treg, const float* regD, const float* xip,
                   const float* xid, float* dx, float* dy, float* work,
                   int batch, int m, int n, int refine, size_t smem,
                   cudaStream_t s) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_solve_kernel<kShared, kVecs>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int threads = kShared ? (m <= 64 ? 128 : 256) : 1024;
  fused_solve_kernel<kShared, kVecs><<<batch, threads, smem, s>>>(
      A, Li, d, treg, regD, xip, xid, dx, dy, work, m, n, refine);
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

// Solve `batch` instances (row-major A (batch, m, n), Li (batch, m, m),
// d/treg/xid (batch, n), regD/xip (batch, m)) into dx (batch, n) and dy
// (batch, m), launched on `stream` of `device`. `work` holds the floats
// that tulip_fused_k1_solve_workspace asks for, times `batch` (may be null
// when that is 0). Outputs must not alias inputs or `work`. `*layout` is set
// to 2 when A and Li were staged in shared memory, 1 when they were read
// from device memory, 0 when the n-long vectors were too. Returns the
// cudaError_t of the launch (0 on success); does not synchronise.
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
    err = launch<true, true>(A, Li, d, treg, regD, xip, xid, dx, dy, work,
                             batch, m, n, refine, smem, s);
  } else if (how == kStreamed) {
    err = launch<false, true>(A, Li, d, treg, regD, xip, xid, dx, dy, work,
                              batch, m, n, refine, smem, s);
  } else {
    err = launch<false, false>(A, Li, d, treg, regD, xip, xid, dx, dy, work,
                               batch, m, n, refine, smem, s);
  }
  *layout = static_cast<int>(how);
  return static_cast<int>(err);
}
