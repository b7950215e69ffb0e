// Fused k-means assignment for sm_90a: distance + running argmin over
// centroid tiles.
//
// Replaces the TPU kernel `kmeans_assign` (repro/kernels/kmeans_assign.py,
// `_assign_kernel`): assign[n] = argmin_b ||x_n - c_b||^2 by the expansion
// ||x||^2 - 2 x.c + ||c||^2 with f32 accumulation (bf16 inputs are upcast
// with __bfloat162float), min_d2[n] = that minimum; the lowest centroid index
// wins an exact tie. As on the TPU, the [N, B] distance matrix never reaches
// device memory.
//
// What bounds it on an H100: 2*N*B*d flops at the CUDA-core f32 rate (no
// tensor cores here): ~4.0 ms for N = 1M, B = 1024, d = 128, against
// ~0.15 ms to read x once.
//
// What this simple design does about it: a register-tiled product, as in a
// plain SGEMM. A block of 256 threads owns 128 points and walks the
// centroids in tiles of 128; for each tile it streams d in chunks of 16
// through shared memory, both operands transposed so that each thread reads
// float4s of its 8 points and its 8 centroids (2 distinct point float4s per
// warp: broadcasts) and does 64 FMAs per 4 shared loads. After each centroid
// tile a thread folds its 8 x 8 distances into a running (min, argmin) per
// point in registers; at the end the 16 threads that share a point reduce
// theirs by shuffles under the (dist, index) key. Centroid norms are computed
// once per launch by a small first kernel; point norms by the block, during
// its first centroid tile. Ragged N, B and d are masked, never padded.
// Double-buffered loads, TF32 and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileN = 128;  // points per block
constexpr int kTileB = 128;  // centroids per tile
constexpr int kTileK = 16;   // depth per shared-memory chunk
constexpr int kPad = 4;      // row padding of the transposed chunks (keeps float4 alignment)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ bool key_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// ||c_b||^2, one warp per centroid.
template <typename T>
__global__ void centroid_norms_kernel(const T* __restrict__ c, int B, int d,
                                      float* __restrict__ csq) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (b >= B) return;
  float acc = 0.f;
  for (int j = lane; j < d; j += 32) {
    const float v = to_f32(c[(size_t)b * d + j]);
    acc = fmaf(v, v, acc);
  }
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) csq[b] = acc;
}

// two blocks an SM: at most 128 registers a thread
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
kmeans_assign_kernel(const T* __restrict__ x, const T* __restrict__ c,
                     const float* __restrict__ csq, int N, int B, int d,
                     int* __restrict__ oa, float* __restrict__ od) {
  __shared__ __align__(16) float xs[kTileK][kTileN + kPad];
  __shared__ __align__(16) float cs[kTileK][kTileB + kPad];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n0 = blockIdx.x * kTileN;
  // this thread's points: ty*4 + {0..3} and 64 + ty*4 + {0..3} of the block;
  // its centroids: tx*4 + {0..3} and 64 + tx*4 + {0..3} of each tile
  float xsq[8], best[8];
  int arg[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) { xsq[i] = 0.f; best[i] = CUDART_INF_F; arg[i] = 0; }

  for (int b0 = 0; b0 < B; b0 += kTileB) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += kTileK) {
      for (int e = tid; e < kTileN * kTileK; e += kThreads) {
        const int r = e / kTileK, j = e % kTileK, kk = k0 + j;
        const int n = n0 + r, b = b0 + r;
        xs[j][r] = (n < N && kk < d) ? to_f32(x[(size_t)n * d + kk]) : 0.f;
        cs[j][r] = (b < B && kk < d) ? to_f32(c[(size_t)b * d + kk]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < kTileK; ++j) {
        const float4 a0 = *reinterpret_cast<const float4*>(&xs[j][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&xs[j][64 + ty * 4]);
        const float4 c0 = *reinterpret_cast<const float4*>(&cs[j][tx * 4]);
        const float4 c1 = *reinterpret_cast<const float4*>(&cs[j][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) acc[i][jj] = fmaf(a[i], cv[jj], acc[i][jj]);
        if (b0 == 0) {
#pragma unroll
          for (int i = 0; i < 8; ++i) xsq[i] = fmaf(a[i], a[i], xsq[i]);
        }
      }
      __syncthreads();
    }

    // fold the tile into the running (min, argmin), in increasing index
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int b = b0 + (jj < 4 ? tx * 4 + jj : 64 + tx * 4 + jj - 4);
      if (b < B) {
        const float cn = csq[b];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float dist = xsq[i] - 2.0f * acc[i][jj] + cn;
          if (key_less(dist, b, best[i], arg[i])) { best[i] = dist; arg[i] = b; }
        }
      }
    }
  }

  // the 16 threads of a half-warp share their points: reduce under (dist, index)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    for (int off = 8; off > 0; off >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oa_ = __shfl_xor_sync(0xffffffffu, arg[i], off);
      if (key_less(ob, oa_, best[i], arg[i])) { best[i] = ob; arg[i] = oa_; }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int n = n0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
      if (n < N) { oa[n] = arg[i]; od[n] = best[i]; }
    }
  }
}

template <typename T>
int launch(const void* x, int N, const void* c, int B, int d, void* csq, void* oa, void* od,
           void* stream) {
  if (N == 0) return 0;
  if (B < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  centroid_norms_kernel<T><<<(B + 7) / 8, 256, 0, st>>>((const T*)c, B, d, (float*)csq);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  kmeans_assign_kernel<T><<<(N + kTileN - 1) / kTileN, kThreads, 0, st>>>(
      (const T*)x, (const T*)c, (const float*)csq, N, B, d, (int*)oa, (float*)od);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x [N, d], centroids [B, d] (both f32 or both bf16), csq [B] f32 scratch
// -> oa [N] int32, od [N] f32. Returns a cudaError_t.
int kmeans_assign_f32(const void* x, int N, const void* c, int B, int d, void* csq, void* oa,
                      void* od, void* stream) {
  return launch<float>(x, N, c, B, d, csq, oa, od, stream);
}

int kmeans_assign_bf16(const void* x, int N, const void* c, int B, int d, void* csq, void* oa,
                       void* od, void* stream) {
  return launch<__nv_bfloat16>(x, N, c, B, d, csq, oa, od, stream);
}

}  // extern "C"
