// Fused k-means assignment for sm_90a on the tensor cores: the point-centroid
// products on wgmma, distance and running argmin in registers.
//
// Replaces the TPU kernel `kmeans_assign` (repro/kernels/kmeans_assign.py,
// `_assign_kernel`): assign[n] = argmin_b ||x_n - c_b||^2 by the expansion
// ||x||^2 - 2 x.c + ||c||^2 with f32 accumulation, min_d2[n] = that minimum;
// the lowest centroid index wins an exact tie. As on the TPU, the [N, B]
// distance matrix never reaches device memory.
//
// What bounds it on an H100: the product. A single TF32 product rounds each
// operand to an 11-bit significand, too coarse for the f32 parity rule
// (rtol 1e-5); so f32 inputs take three TF32 products, x.c ~ x_hi.c_lo +
// x_lo.c_hi + x_hi.c_hi with v_hi = tf32(v) (round to nearest, cvt.rna) and
// v_lo = v - v_hi exact in f32 (x_lo.c_lo dropped): relative error ~2^-21.
// That is 3 * 2*N*B*d flops at the dense TF32 rate (495 TFLOP/s): ~1.6 ms for
// N = 1M, B = 1024, d = 128. bf16 products are exact in f32, so bf16 inputs
// take one bf16 product (989 TFLOP/s). ||x||^2 and ||c||^2 are fmaf chains
// on the CUDA cores, as is the epilogue (~4 operations a pair).
//
// The design. A block is three warpgroups and lives on its SM for the whole
// launch (one block an SM, ~225 KB of shared memory), taking point tiles of
// 128 rows in turn:
//  - warpgroups 0 and 1 (consumers) each own 64 rows of the tile; for every
//    centroid tile of 128 they run m64n128 wgmmas with both operands in
//    128-byte-swizzled shared memory, then fold dist = xsq - 2 acc + csq into
//    a per-row (min, argmin) in registers, columns in ascending index; at the
//    end the four lanes that share a row reduce under the (dist, index) key;
//  - warpgroup 2 (producer, registers given up with setmaxnreg): one lane
//    starts TMA loads of 128-byte chunks of d (32 f32 or 64 bf16) into
//    shared memory, completing on mbarriers. The point tile's chunks (up to
//    4: d <= 128 f32, <= 256 bf16) stay resident over the whole centroid
//    loop, and three warps split each f32 one in place into its hi and lo
//    planes, so each point is split once a launch. Centroid chunks pass
//    through a ring of stages straight from TMA: the first kernel wrote the
//    centroids' hi and lo planes to scratch once a launch (1 MB at B = 1024,
//    d = 128). Splitting them in shared memory instead, to halve their L2
//    feed, was slower on an H100: three warps splitting every chunk of every
//    centroid tile could not keep up with the tensor cores. As it stands the
//    kernel is bound inside each SM, not by L2: on an H100 its time scales as
//    1 / blocks from a quarter of the SMs to all of them.
//  - A wider d is cut into panels of 4 chunks that are loaded again for
//    every centroid tile. Rows whose stride is not a multiple of 16 bytes
//    (d % 4 != 0 f32, d % 8 != 0 bf16) or an unaligned base skip TMA: the
//    splitting warps load them through registers, zero-filled.
// K is padded to whole chunks with zeros in shared memory only (TMA fills
// out-of-range rows and columns with zeros); centroid columns past B meet
// csq = +inf (the first kernel pads them), so they never enter the fold.
// No atomics; the order of every sum is fixed, so two runs give the same bits.

#include <cuda.h>  // CUtensorMap and its enums; libcuda's encoder is found at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <math_constants.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kConsumers = 2;                   // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kTileN = 64 * kConsumers;         // points a tile
constexpr int kTileB = 128;                     // centroids a tile: the wgmma's N
constexpr int kRowBytes = 128;                  // a chunk row: one 128-byte swizzle span
constexpr int kXSlots = 4;                      // resident point chunks (a panel)
constexpr int kSplitters = 96;                  // producer warps 1-3
constexpr int kXChunkBytes = kTileN * kRowBytes;
constexpr int kCChunkBytes = kTileB * kRowBytes;

template <typename T> struct Cfg;
// f32: hi and lo planes; 128 KB of points + 3 x 32 KB of centroid stages
template <> struct Cfg<float> { static constexpr int kPlanes = 2, kStages = 3; };
// bf16: one plane; a chunk is consumed 3x faster, so the ring is deeper
template <> struct Cfg<__nv_bfloat16> { static constexpr int kPlanes = 1, kStages = 8; };

template <typename T> struct Layout {
  static constexpr int kChunk = kRowBytes / sizeof(T);  // elements of d a chunk
  static constexpr int kXBytes = kXSlots * Cfg<T>::kPlanes * kXChunkBytes;
  static constexpr int kRingBytes = Cfg<T>::kStages * Cfg<T>::kPlanes * kCChunkBytes;
  static constexpr int kBars = 2 * Cfg<T>::kStages + 3 * kXSlots;
  static constexpr int kSmem = 1024 + kXBytes + kRingBytes + 8 * kBars;  // 1024: alignment
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// one 16-byte unit of a chunk row
template <typename T> union Unit {
  T e[16 / sizeof(T)];
  uint4 u;
};

__device__ __forceinline__ bool key_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// ---------------------------------------------------------------- PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait for the phase of parity `parity` to complete. A wait of seconds means a
// lost phase (a fault in this file): trap, so the launch fails, not hangs.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t i = 1;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if ((i & 1023) == 0) {
      const uint64_t now = global_ns();
      if (t0 == 0) t0 = now;
      else if (now - t0 > 4000000000ull) __trap();
    }
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// one 2D tile (a chunk of d x rows) from global to shared memory, 128-byte swizzled
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// generic-proxy writes to shared memory made visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// wgmma operand descriptor: K-major, 128-byte swizzle, 8-row groups 1024 B apart
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// pin the accumulator after a wait, so that no read of it moves above the wait
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 128] (+)= A[64 x k] . B[128 x k]^T, both operands from shared memory;
// scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}
// ---------------------------------------------------------------- staging

// Split a TMA-loaded f32 point chunk in place: hi = tf32(v) over v, lo = v - hi
// in the next plane (same swizzled offsets). bf16 chunks are used as loaded.
template <typename T>
__device__ __forceinline__ void split_in_place(uint8_t* buf, int bytes, int tid) {
  if constexpr (Cfg<T>::kPlanes == 2) {
    float4* hi = reinterpret_cast<float4*>(buf);
    float4* lo = reinterpret_cast<float4*>(buf + bytes);
    for (int u = tid; u < bytes / 16; u += kSplitters) {
      const float4 v = hi[u];
      const float4 h = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
      hi[u] = h;
      lo[u] = make_float4(v.x - h.x, v.y - h.y, v.z - h.z, v.w - h.w);
    }
  }
}

// Load a chunk (rows row0.. of src [nrows, d], columns col0..) through
// registers, zero-filled past nrows and d, into the swizzled layout TMA would
// have written, split as split_in_place would leave it.
template <typename T>
__device__ __forceinline__ void load_split(uint8_t* buf, int rows, const T* __restrict__ src,
                                           int row0, int nrows, int col0, int d, int tid) {
  constexpr int kPer = 16 / sizeof(T);  // elements a 16-byte unit
  for (int u = tid; u < rows * 8; u += kSplitters) {
    const int r = u >> 3, lu = u & 7, n = row0 + r;
    const int off = r * kRowBytes + ((lu ^ (r & 7)) << 4);
    Unit<T> v;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = col0 + lu * kPer + i;
      v.e[i] = (n < nrows && e < d) ? src[static_cast<size_t>(n) * d + e] : T(0.f);
    }
    if constexpr (Cfg<T>::kPlanes == 2) {
      Unit<T> lo;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float h = tf32_rna(v.e[i]);
        lo.e[i] = v.e[i] - h;
        v.e[i] = h;
      }
      *reinterpret_cast<uint4*>(buf + rows * kRowBytes + off) = lo.u;
    }
    *reinterpret_cast<uint4*>(buf + off) = v.u;
  }
}

// sum of squares of one row's two 16-byte units u0 and u0 + 4 of a resident
// point chunk (x = hi + lo exactly for f32), continuing the chain acc
template <typename T>
__device__ __forceinline__ float row_sq(const uint8_t* row, int r, int u0, float acc) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int off = ((u0 + 4 * k) ^ (r & 7)) << 4;
    if constexpr (Cfg<T>::kPlanes == 2) {
      const float4 h = *reinterpret_cast<const float4*>(row + off);
      const float4 l = *reinterpret_cast<const float4*>(row + kXChunkBytes + off);
      acc = fmaf(h.x + l.x, h.x + l.x, acc);
      acc = fmaf(h.y + l.y, h.y + l.y, acc);
      acc = fmaf(h.z + l.z, h.z + l.z, acc);
      acc = fmaf(h.w + l.w, h.w + l.w, acc);
    } else {
      Unit<T> w;
      w.u = *reinterpret_cast<const uint4*>(row + off);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float v = to_f32(w.e[i]);
        acc = fmaf(v, v, acc);
      }
    }
  }
  return acc;
}

// ---------------------------------------------------------------- kernels

// ||c_b||^2, one warp per centroid; +inf for the padding columns B..b_pad-1.
// For f32 also the centroids' hi and lo planes [B, d] (chi, clo), read by TMA.
template <typename T>
__global__ void centroid_prep_kernel(const T* __restrict__ c, int B, int d, int b_pad,
                                     float* __restrict__ csq, float* __restrict__ chi,
                                     float* __restrict__ clo) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= b_pad) return;
  float acc = 0.f;
  if (b < B) {
    for (int j = lane; j < d; j += 32) {
      const size_t i = static_cast<size_t>(b) * d + j;
      const float v = to_f32(c[i]);
      acc = fmaf(v, v, acc);
      if constexpr (Cfg<T>::kPlanes == 2) {
        const float h = tf32_rna(v);
        chi[i] = h;
        clo[i] = v - h;
      }
    }
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  } else {
    acc = CUDART_INF_F;
  }
  if (lane == 0) csq[b] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
kmeans_assign_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap cmap, const __grid_constant__ CUtensorMap cmap_lo,
                     const T* __restrict__ x,
                     const T* __restrict__ c, const float* __restrict__ csq, int N, int B, int d,
                     int use_tma, int* __restrict__ oa, float* __restrict__ od) {
  using L = Layout<T>;
  constexpr int S = Cfg<T>::kStages, P = Cfg<T>::kPlanes, KC = L::kChunk;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* ring = xs + L::kXBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + L::kRingBytes);  // ready for wgmma
  uint64_t* empty = full + S;     // wgmma done with it
  uint64_t* xloaded = empty + S;  // TMA landed, not yet split
  uint64_t* xfull = xloaded + kXSlots;
  uint64_t* xempty = xfull + kXSlots;

  const int nk = d > 0 ? (d + KC - 1) / KC : 1;  // chunks of d (d = 0: one chunk of zeros)
  const int nbt = (B + kTileB - 1) / kTileB;
  const int ntiles = (N + kTileN - 1) / kTileN;
  // centroid tiles a point chunk is loaded for: all of them when d fits one panel
  const int reuse = nk <= kXSlots ? nbt : 1;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], use_tma ? 1 : kSplitters);  // TMA's arrival, or the loading warps
      mbar_init(&empty[s], 4 * kConsumers);
    }
    for (int q = 0; q < kXSlots; ++q) {
      mbar_init(&xloaded[q], 1);
      mbar_init(&xfull[q], kSplitters);
      mbar_init(&xempty[q], 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) & 3, lane = threadIdx.x & 31;
  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (warp == 0) {
      if (!use_tma || lane != 0) return;
      uint32_t xph = 0;
      int e = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x)
        for (int j = 0; j < nbt; ++j)
          for (int kc = 0; kc < nk; ++kc, ++e) {
            const int q = kc % kXSlots, s = e % S;
            if (j % reuse == 0) {
              mbar_wait(&xempty[q], ((xph >> q) & 1) ^ 1);
              xph ^= 1u << q;
              mbar_expect_tx(&xloaded[q], kXChunkBytes);
              tma_load(xs + q * P * kXChunkBytes, &xmap, &xloaded[q], kc * KC, t * kTileN);
            }
            mbar_wait(&empty[s], ((e / S) & 1) ^ 1);
            uint8_t* buf = ring + s * P * kCChunkBytes;
            mbar_expect_tx(&full[s], P * kCChunkBytes);
            tma_load(buf, &cmap, &full[s], kc * KC, j * kTileB);
            if constexpr (P == 2) tma_load(buf + kCChunkBytes, &cmap_lo, &full[s], kc * KC, j * kTileB);
          }
    } else {
      const int tid = threadIdx.x - kConsumers * 128 - 32;
      uint32_t xph = 0;
      int e = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x)
        for (int j = 0; j < nbt; ++j)
          for (int kc = 0; kc < nk; ++kc, ++e) {
            const int q = kc % kXSlots, s = e % S;
            if (j % reuse == 0) {
              uint8_t* buf = xs + q * P * kXChunkBytes;
              if (use_tma) {
                mbar_wait(&xloaded[q], (xph >> q) & 1);
                split_in_place<T>(buf, kXChunkBytes, tid);
              } else {
                mbar_wait(&xempty[q], ((xph >> q) & 1) ^ 1);
                load_split<T>(buf, kTileN, x, t * kTileN, N, kc * KC, d, tid);
              }
              xph ^= 1u << q;
              fence_proxy_async();
              mbar_arrive(&xfull[q]);
            }
            if (!use_tma) {  // with TMA the centroid chunks land on full[s] themselves
              mbar_wait(&empty[s], ((e / S) & 1) ^ 1);
              load_split<T>(ring + s * P * kCChunkBytes, kTileB, c, j * kTileB, B, kc * KC, d, tid);
              fence_proxy_async();
              mbar_arrive(&full[s]);
            }
          }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    const int r0 = 16 * warp + (lane >> 2);  // this lane's rows of the warpgroup's 64: r0, r0 + 8
    const int qd = lane & 3;                 // its columns: 8 i + 2 qd + {0, 1}
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    uint32_t xph = 0;
    int e = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      float best0 = CUDART_INF_F, best1 = CUDART_INF_F, xsq0 = 0.f, xsq1 = 0.f;
      int arg0 = 0, arg1 = 0;
      for (int j = 0; j < nbt; ++j) {
        const bool fresh = j % reuse == 0, last = j % reuse == reuse - 1;
        for (int kc = 0; kc < nk; ++kc, ++e) {
          const int q = kc % kXSlots, s = e % S;
          if (fresh) {
            mbar_wait(&xfull[q], (xph >> q) & 1);
            xph ^= 1u << q;
          }
          mbar_wait(&full[s], (e / S) & 1);
          const uint8_t* xa = xs + q * P * kXChunkBytes + wg * 64 * kRowBytes;
          const uint8_t* cb = ring + s * P * kCChunkBytes;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {  // 32 bytes of K a step: k8 tf32, k16 bf16
            const int first = kc == 0 && kk == 0;
            if constexpr (P == 2) {
              // the two cross terms first, then hi . hi
              wgmma_tf32(acc, sw128_desc(xa + 32 * kk), sw128_desc(cb + kCChunkBytes + 32 * kk),
                         !first);
              wgmma_tf32(acc, sw128_desc(xa + kXChunkBytes + 32 * kk), sw128_desc(cb + 32 * kk), 1);
              wgmma_tf32(acc, sw128_desc(xa + 32 * kk), sw128_desc(cb + 32 * kk), 1);
            } else {
              wgmma_bf16(acc, sw128_desc(xa + 32 * kk), sw128_desc(cb + 32 * kk), !first);
            }
          }
          wgmma_commit();
          if (j == 0) {  // ||x||^2 while the tensor cores work: a quarter of each row a lane
            xsq0 = row_sq<T>(xa + r0 * kRowBytes, r0, qd, xsq0);
            xsq1 = row_sq<T>(xa + (r0 + 8) * kRowBytes, r0 + 8, qd, xsq1);
          }
          if (kc > 0) {  // the previous chunk's products are done: hand back its buffers
            wgmma_wait<1>();
            if (lane == 0) {
              mbar_arrive(&empty[(e - 1) % S]);
              if (last) mbar_arrive(&xempty[(kc - 1) % kXSlots]);
            }
          }
        }
        wgmma_wait<0>();
        if (lane == 0) {
          mbar_arrive(&empty[(e - 1) % S]);
          if (last) mbar_arrive(&xempty[(nk - 1) % kXSlots]);
        }
        fence_acc(acc);
        if (j == 0) {  // the four lanes of a row hold a quarter each
          xsq0 += __shfl_xor_sync(0xffffffffu, xsq0, 1);
          xsq0 += __shfl_xor_sync(0xffffffffu, xsq0, 2);
          xsq1 += __shfl_xor_sync(0xffffffffu, xsq1, 1);
          xsq1 += __shfl_xor_sync(0xffffffffu, xsq1, 2);
        }
        // fold the tile, columns in ascending index (padding columns have csq = +inf)
#pragma unroll
        for (int i = 0; i < kTileB / 8; ++i) {
          const int col = j * kTileB + 8 * i + 2 * qd;
          const float2 cn = __ldg(reinterpret_cast<const float2*>(csq + col));
          float dd = xsq0 - 2.0f * acc[4 * i] + cn.x;
          if (dd < best0) { best0 = dd; arg0 = col; }
          dd = xsq0 - 2.0f * acc[4 * i + 1] + cn.y;
          if (dd < best0) { best0 = dd; arg0 = col + 1; }
          dd = xsq1 - 2.0f * acc[4 * i + 2] + cn.x;
          if (dd < best1) { best1 = dd; arg1 = col; }
          dd = xsq1 - 2.0f * acc[4 * i + 3] + cn.y;
          if (dd < best1) { best1 = dd; arg1 = col + 1; }
        }
      }
      // the four lanes of a row: reduce under (dist, index)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        float ob = __shfl_xor_sync(0xffffffffu, best0, off);
        int oi = __shfl_xor_sync(0xffffffffu, arg0, off);
        if (key_less(ob, oi, best0, arg0)) { best0 = ob; arg0 = oi; }
        ob = __shfl_xor_sync(0xffffffffu, best1, off);
        oi = __shfl_xor_sync(0xffffffffu, arg1, off);
        if (key_less(ob, oi, best1, arg1)) { best1 = ob; arg1 = oi; }
      }
      const int n0 = t * kTileN + wg * 64 + r0;
      if (qd == 0) {
        if (n0 < N) { oa[n0] = arg0; od[n0] = best0; }
        if (n0 + 8 < N) { oa[n0 + 8] = arg1; od[n0 + 8] = best1; }
      }
    }
  }
}

// ---------------------------------------------------------------- host side

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled (already loaded by the caller's CUDA runtime)
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h ? reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

template <typename T>
bool tma_ok(const void* x, const void* c, int d) {
  return d > 0 && (static_cast<size_t>(d) * sizeof(T)) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(c) % 16 == 0;
}

// rows x d, boxes of (one chunk of d) x box_rows, 128-byte swizzle, zeros out of range
template <typename T>
bool encode(CUtensorMap* map, const void* ptr, int rows, int d, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(Layout<T>::kChunk),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapDataType dt = sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                                : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  EncodeTiled fn = encoder();
  return fn != nullptr &&
         fn(map, dt, 2, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int blocks_for(int N) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  const int ntiles = (N + kTileN - 1) / kTileN;
  return ntiles < sms ? ntiles : sms;
}

int padded_centroids(int B) { return (B + kTileB - 1) / kTileB * kTileB; }

// scratch floats: ||c||^2 padded to whole centroid tiles, then (f32) the hi and
// lo planes of the centroids
template <typename T>
size_t scratch_floats(int B, int d) {
  return padded_centroids(B) + (Cfg<T>::kPlanes == 2 ? 2 * static_cast<size_t>(B) * d : 0);
}

template <typename T>
int launch(const void* x, int N, const void* c, int B, int d, void* scratch, void* oa, void* od,
           void* stream) {
  if (N == 0) return 0;
  if (N < 0 || B < 1 || d < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int b_pad = padded_centroids(B);
  float* csq = static_cast<float*>(scratch);
  float* chi = csq + b_pad;                       // 512-byte aligned
  float* clo = chi + static_cast<size_t>(B) * d;  // 16-byte aligned whenever TMA is used
  centroid_prep_kernel<T><<<(b_pad + 7) / 8, 256, 0, st>>>(static_cast<const T*>(c), B, d,
                                                           b_pad, csq, chi, clo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap xm, cm, cl;
  memset(&xm, 0, sizeof(xm));
  memset(&cm, 0, sizeof(cm));
  memset(&cl, 0, sizeof(cl));
  const bool tma = tma_ok<T>(x, c, d);
  const bool split = Cfg<T>::kPlanes == 2;
  if (tma && !(encode<T>(&xm, x, N, d, kTileN) && encode<T>(&cm, split ? chi : c, B, d, kTileB) &&
               (!split || encode<T>(&cl, clo, B, d, kTileB))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = blocks_for(N);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidDevice);
  auto kernel = kmeans_assign_kernel<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Layout<T>::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kThreads, Layout<T>::kSmem, st>>>(
      xm, cm, cl, static_cast<const T*>(x), static_cast<const T*>(c), csq,
      N, B, d, tma ? 1 : 0, static_cast<int*>(oa), static_cast<float*>(od));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
void shape(const void* x, int N, const void* c, int d, int* out) {
  out[0] = kTileN;
  out[1] = kTileB;
  out[2] = Cfg<T>::kStages;
  out[3] = Layout<T>::kChunk;
  out[4] = kXSlots;
  out[5] = blocks_for(N);
  out[6] = Layout<T>::kSmem;
  out[7] = kThreads;
  out[8] = tma_ok<T>(x, c, d) ? 1 : 0;
}

}  // namespace

extern "C" {

// x [N, d], centroids [B, d] (both f32 or both bf16), f32 scratch of
// kmeans_assign_scratch_len(B, d, bf16) floats, 16-byte aligned -> oa [N]
// int32, od [N] f32. Returns a cudaError_t.
int kmeans_assign_f32(const void* x, int N, const void* c, int B, int d, void* scratch,
                      void* oa, void* od, void* stream) {
  return launch<float>(x, N, c, B, d, scratch, oa, od, stream);
}

int kmeans_assign_bf16(const void* x, int N, const void* c, int B, int d, void* scratch,
                       void* oa, void* od, void* stream) {
  return launch<__nv_bfloat16>(x, N, c, B, d, scratch, oa, od, stream);
}

long long kmeans_assign_scratch_len(int B, int d, int bf16) {
  return static_cast<long long>(bf16 ? scratch_floats<__nv_bfloat16>(B, d)
                                     : scratch_floats<float>(B, d));
}

// the launch shape: out[9] = point tile, centroid tile, ring stages, chunk
// depth (elements of d), resident point chunks, blocks, shared memory bytes a
// block, threads a block, 1 if loads go through TMA (else through registers)
void kmeans_assign_shape(const void* x, int N, const void* c, int d, int bf16, int* out) {
  if (bf16)
    shape<__nv_bfloat16>(x, N, c, d, out);
  else
    shape<float>(x, N, c, d, out);
}

}  // extern "C"
