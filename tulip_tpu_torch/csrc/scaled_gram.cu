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
// bound by operations (~1000 per byte of A). The FP32 FMA pipes (67 TFLOP/s
// published, H100 SXM) are the wrong unit for that: the tensor cores take
// TF32 at 495 TFLOP/s, and both operands are K-major (rows of A, k
// contiguous), which is what they read. One TF32 pass keeps ~3 digits and
// would spoil the Cholesky that follows, so every product is made of three:
// each operand x is split into hi = tf32(x) and lo = x - hi (of which the
// tensor cores read the TF32 part), and lo*hi + hi*lo + hi*hi is summed in
// the f32 accumulator, small terms first. The dropped lo*lo is ~2^-22 of the
// product. The tensor cores add into their accumulator by truncation, and
// over thousands of k that bias grows to ~6e-5 of max|K| at n = 6240
// (measured), so they sum only 32 k-values at a time from zero, and the
// partial sums are added to the running sums by FP32 adds, which round to
// nearest. Bound restated for this unit: 3 m (m + 1) n operations at 495
// TFLOP/s.
//
// What holds it back at that shape (measured by leaving parts out, see
// GRAM_LEAVE_OUT below; NVIDIA H100 80GB HBM3): the products alone take
// ~0.87 ms, the loads and the split pass alone ~1.0 ms, together 1.35 ms.
// Every tile streams its 256 rows of A from the L2 cache, 3.4 GB a launch
// whatever fits in the cache, and a thread has registers for one stage in
// flight beside the two accumulators, so a stage cannot run much faster
// than one load's latency under that traffic. Larger tiles or one load
// shared by a cluster of blocks would cut it; neither is done here.
//
// What the design does about it:
//
// - One 256-thread block per 128 x 128 tile of K: two warpgroups, each
//   owning 64 rows of the tile, run wgmma.mma_async m64n128k8 TF32 with
//   both operands in shared memory.
// - A stage is 32 k-values of the tile's 128 i-rows and 128 j-rows. Each
//   thread loads its own eight 16-byte chunks of a stage (and its four
//   entries of d) from device memory straight into registers, two stages
//   ahead of the products, and one stage ahead turns them, once, into what
//   the tensor cores read: hi and lo of A d for the row side, hi and lo of
//   A for the column side, four 128 x 32 TF32 tiles in a ring of two
//   buffers. So the scaling by d and the hi/lo split happen once per staged
//   element, in a pass that writes the split tiles to shared memory, not
//   once per use: each element then feeds 128 products on the other side
//   three times over. (Taking the row side from registers instead would
//   make every thread hold fragments of two stages beside two sets of 64
//   accumulators.) Raw tiles never touch shared memory, so its bandwidth
//   goes to the tensor cores' reads (144 KB a stage) and the split tiles'
//   stores (64 KB). On a diagonal tile the i-rows and the j-rows are the
//   same rows: they are loaded once and both sides are split from them.
// - The split pass of stage k + 1 runs between the start of stage k's
//   products and the wait for them, so the FP32 and integer pipes work
//   while the tensor cores do; one barrier over the block a stage orders
//   the buffers' reuse. The TPU's sequential "arbitrary" grid axis over k
//   becomes this loop.
// - The split tiles sit in the layout wgmma's descriptors name as K-major
//   with the 128-byte swizzle: a row is one 128-byte line, its 16-byte
//   chunks XOR-ed with the row number (chunk ^ (row & 7)), 8 rows a 1024-byte
//   group. A k-step of 8 moves the descriptor's start by 32 bytes.
// - Per stage a warpgroup starts 12 wgmma (4 k-steps x lo*hi, hi*lo, hi*hi)
//   into a partial accumulator that starts from zero, then adds the partial
//   sums to its running sums with FP32 adds.
// - Ragged edges in m and n are masked in the kernel: loads of rows >= m and
//   k >= n are replaced by zeros, and the stores skip them. The host pads
//   nothing. Where n is not a multiple of 4 or a pointer is not 16-byte
//   aligned, the chunks are loaded float by float.
// - The grid is one-dimensional over (lane, lower tile), so the hardware
//   hands a tile to whichever SM frees up and only the very last tiles run
//   on a partly empty card: 528 tiles at m = 4096, four to an SM.
// - The finished tile goes through shared memory (the ring is free by
//   then) so that both K[i][j] and its mirror K[j][i] are written along
//   rows.
//
// No --use_fast_math. Build: nvcc -gencode arch=compute_90a,code=sm_90a
// -std=c++17 -O3 -shared -Xcompiler -fPIC (wgmma needs the "a").

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

// For diagnosis only (time_kernels.py --leave-out): a build with
// -DGRAM_LEAVE_OUT=1 drops the split pass, 2 the products, 3 the loads. Its
// K is wrong; only its time means anything.
#ifndef GRAM_LEAVE_OUT
#define GRAM_LEAVE_OUT 0
#endif

constexpr int kTile = 128;     // rows (and columns) of a K tile
constexpr int kBK = 32;        // k values per stage: one 128-byte line a row
constexpr int kSplitStages = 2;
constexpr int kThreads = 256;  // two warpgroups
constexpr int kSide = kTile * kBK;              // floats of one 128 x 32 tile
constexpr int kSplitFloats = 4 * kSide;         // i hi, i lo, j hi, j lo
// 16-byte chunks of one side's tile that a thread loads and splits.
constexpr int kChunks = kSide / 4 / kThreads;
constexpr int kOutLd = kTile + 1;               // row stride of the out tile
constexpr size_t kSplitBytes = sizeof(float) * kSplitStages * kSplitFloats;
constexpr size_t kSmemBytes = kSplitBytes + 1024;  // + room to align
static_assert(kSplitBytes >= sizeof(float) * kTile * kOutLd,
              "the output tile reuses the ring");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// x = hi + lo exactly: hi is x rounded to TF32's 10 mantissa bits (to
// nearest, ties away from zero, what cvt.rna.tf32.f32 gives), by integer
// arithmetic on the bits, because the conversion instruction runs at a
// fraction of the integer and FP32 rate and this pass is all conversions;
// lo is the rest, at most 2^-11 |x|, of which the tensor cores read the
// leading 11 bits (they ignore an operand's last 13), so the split loses
// ~2^-22 |x|, as the dropped lo*lo does. A NaN or Inf x gives a NaN lo.
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
  lo = x - hi;
}

// Descriptor of a K-major tile with the 128-byte swizzle: start address,
// leading byte offset 1 (not used by swizzled K-major layouts), 1024 bytes
// from one group of 8 rows to the next, layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t wgmma_desc(const float* tile) {
  uint64_t desc = (smem_u32(tile) & 0x3FFFF) >> 4;
  desc |= static_cast<uint64_t>(1) << 16;
  desc |= static_cast<uint64_t>(1024 >> 4) << 32;
  desc |= static_cast<uint64_t>(1) << 62;
  return desc;
}

// d (64 x 128, f32, 64 registers a thread) = a (64 x 8) b^T (128 x 8) + d,
// or without "+ d" when scale_d is 0.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], uint64_t a,
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Keeps the compiler from moving the accumulators across the asynchronous
// products.
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One thread's share of a stage, in registers: chunk e is row
// (tid >> 3) + 32 e, k-values 4 (tid & 7) .. + 3 of the stage.
struct Staged {
  float4 i[kChunks];
  float4 j[kChunks];
  float4 d;
};

// Four floats at p, those at k + c >= n replaced by zero. kVec: one 16-byte
// load (n % 4 == 0, aligned pointers), all or nothing.
template <bool kVec>
__device__ __forceinline__ float4 load4(const float* p, int k, int n,
                                        bool row_ok) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (kVec) {
    if (row_ok && k < n) v = *reinterpret_cast<const float4*>(p);
  } else if (row_ok) {
    if (k < n) v.x = p[0];
    if (k + 1 < n) v.y = p[1];
    if (k + 2 < n) v.z = p[2];
    if (k + 3 < n) v.w = p[3];
  }
  return v;
}

// This thread's chunks of the stage that starts at k-value k0. gi and gj
// point at its first chunk's row and k-offset at k0 = 0; rows 32 apart are
// `step` floats apart. ok_i / ok_j: bit e set when chunk e's row is < m.
template <bool kVec>
__device__ __forceinline__ void load_stage(Staged& s, const float* gi,
                                           const float* gj, const float* gd,
                                           size_t step, unsigned ok_i,
                                           unsigned ok_j, bool diag, int k,
                                           int k0, int n) {
#pragma unroll
  for (int e = 0; e < kChunks; ++e) {
    s.i[e] = load4<kVec>(gi + e * step + k0, k, n, (ok_i >> e) & 1);
    if (!diag) s.j[e] = load4<kVec>(gj + e * step + k0, k, n, (ok_j >> e) & 1);
  }
  s.d = load4<kVec>(gd + k0, k, n, true);
}

// Registers -> split buffer: hi/lo of A d (row side) and of A (column
// side), each 16-byte chunk to its swizzled place.
__device__ __forceinline__ void split_stage(const Staged& s, float* out,
                                            bool diag, int tid) {
  const int ch = tid & 7;
#pragma unroll
  for (int e = 0; e < kChunks; ++e) {
    const int row = (tid >> 3) + 32 * e;
    const int dst = row * kBK + ((ch ^ (row & 7)) << 2);
    const float4 a = s.i[e];
    const float4 b = diag ? a : s.j[e];
    float4 hi, lo;
    split_tf32(a.x * s.d.x, hi.x, lo.x);
    split_tf32(a.y * s.d.y, hi.y, lo.y);
    split_tf32(a.z * s.d.z, hi.z, lo.z);
    split_tf32(a.w * s.d.w, hi.w, lo.w);
    *reinterpret_cast<float4*>(out + dst) = hi;
    *reinterpret_cast<float4*>(out + kSide + dst) = lo;
    split_tf32(b.x, hi.x, lo.x);
    split_tf32(b.y, hi.y, lo.y);
    split_tf32(b.z, hi.z, lo.z);
    split_tf32(b.w, hi.w, lo.w);
    *reinterpret_cast<float4*>(out + 2 * kSide + dst) = hi;
    *reinterpret_cast<float4*>(out + 3 * kSide + dst) = lo;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
scaled_gram_kernel(const float* __restrict__ A, const float* __restrict__ d,
                   float* __restrict__ K, int m, int n, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment for the swizzled tiles.
  float* split = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int per = tiles * (tiles + 1) / 2;
  const int lane_b = blockIdx.x / per;
  const int t = blockIdx.x - lane_b * per;
  int ti = static_cast<int>((sqrtf(8.0f * t + 1.0f) - 1.0f) * 0.5f);
  while (ti * (ti + 1) / 2 > t) --ti;
  while ((ti + 1) * (ti + 2) / 2 <= t) ++ti;
  const int tj = t - ti * (ti + 1) / 2;
  const bool diag = ti == tj;
  const int i0 = ti * kTile;
  const int j0 = tj * kTile;
  const float* Ab = A + static_cast<size_t>(lane_b) * m * n;
  const float* db = d + static_cast<size_t>(lane_b) * n;
  float* Kb = K + static_cast<size_t>(lane_b) * m * m;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int kt_count = (n + kBK - 1) / kBK;

  // This thread's chunks: rows (tid >> 3) + 32 e, k-offset 4 (tid & 7).
  const int kc = (tid & 7) * 4;
  const int r0 = tid >> 3;
  unsigned ok_i = 0, ok_j = 0;
#pragma unroll
  for (int e = 0; e < kChunks; ++e) {
    ok_i |= (i0 + r0 + 32 * e < m ? 1u : 0u) << e;
    ok_j |= (j0 + r0 + 32 * e < m ? 1u : 0u) << e;
  }
  // Rows past m are never read (ok_i / ok_j), so these may point past A.
  const float* gi = Ab + static_cast<size_t>(i0 + r0) * n + kc;
  const float* gj = Ab + static_cast<size_t>(j0 + r0) * n + kc;
  const float* gd = db + kc;
  const size_t step = static_cast<size_t>(32) * n;

  float acc[64];   // the running sums, added to in FP32
  float part[64];  // the tensor cores' sums over one stage
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;

  // Stage 0 split into buffer 0, stage 1 in registers.
  Staged cur, nxt;
  load_stage<kVec>(cur, gi, gj, gd, step, ok_i, ok_j, diag, kc, 0, n);
  split_stage(cur, split, diag, tid);
  load_stage<kVec>(cur, gi, gj, gd, step, ok_i, ok_j, diag, kBK + kc, kBK, n);
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  for (int kt = 0; kt < kt_count; ++kt) {
    // Stage kt + 2 on its way to registers (zeros past n).
    if (GRAM_LEAVE_OUT != 3) {
      load_stage<kVec>(nxt, gi, gj, gd, step, ok_i, ok_j, diag,
                       (kt + 2) * kBK + kc, (kt + 2) * kBK, n);
    } else {
      nxt = cur;
    }
    const float* sp = split + (kt % kSplitStages) * kSplitFloats;
    const uint64_t ahi = wgmma_desc(sp + wg * 64 * kBK);
    const uint64_t alo = wgmma_desc(sp + kSide + wg * 64 * kBK);
    const uint64_t bhi = wgmma_desc(sp + 2 * kSide);
    const uint64_t blo = wgmma_desc(sp + 3 * kSide);
    fence_regs(part);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < (GRAM_LEAVE_OUT != 2 ? kBK / 8 : 0); ++ks) {
      // 8 k-values on: 32 bytes, 2 in the descriptor's 16-byte units.
      wgmma_m64n128k8(part, alo + 2 * ks, bhi + 2 * ks, ks != 0);
      wgmma_m64n128k8(part, ahi + 2 * ks, blo + 2 * ks, 1);
      wgmma_m64n128k8(part, ahi + 2 * ks, bhi + 2 * ks, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // While the products run: stage kt + 1 into the other buffer, whose
    // last products (stage kt - 1) every warp had waited for before the
    // barrier that ended the last iteration.
    if (kt + 1 < kt_count && GRAM_LEAVE_OUT != 1) {
      split_stage(cur, split + ((kt + 1) % kSplitStages) * kSplitFloats, diag,
                  tid);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    cur = nxt;
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
    __syncthreads();
  }

  // The ring is free: stage the tile in it, then write K[i][j] and the
  // mirror K[j][i], both along rows.
  float* T = split;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  {
    const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2);
    const int c = 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      T[r * kOutLd + 8 * i + c] = acc[4 * i];
      T[r * kOutLd + 8 * i + c + 1] = acc[4 * i + 1];
      T[(r + 8) * kOutLd + 8 * i + c] = acc[4 * i + 2];
      T[(r + 8) * kOutLd + 8 * i + c + 1] = acc[4 * i + 3];
    }
  }
  __syncthreads();
  for (int r = warp; r < kTile; r += kThreads / 32) {
    const int gi_ = i0 + r;
    if (gi_ >= m) break;
    float* dst = Kb + static_cast<size_t>(gi_) * m + j0;
    for (int c = lane; c < kTile; c += 32) {
      if (j0 + c >= m) break;
      // On a diagonal tile the entries right of the diagonal are the
      // mirror of those below it.
      dst[c] = (diag && c > r) ? T[c * kOutLd + r] : T[r * kOutLd + c];
    }
  }
  if (!diag) {
    for (int c = warp; c < kTile; c += kThreads / 32) {
      const int gj_ = j0 + c;
      if (gj_ >= m) break;
      float* dst = Kb + static_cast<size_t>(gj_) * m + i0;
      for (int r = lane; r < kTile; r += 32) {
        if (i0 + r >= m) break;
        dst[r] = T[r * kOutLd + c];
      }
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
  const long long tiles = (m + kTile - 1) / kTile;
  const long long blocks = batch * (tiles * (tiles + 1) / 2);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = n % 4 == 0 && reinterpret_cast<uintptr_t>(A) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(d) % 16 == 0;
  auto kernel = vec ? scaled_gram_kernel<true> : scaled_gram_kernel<false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes,
           static_cast<cudaStream_t>(stream)>>>(A, d, K, m, n,
                                                static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}
