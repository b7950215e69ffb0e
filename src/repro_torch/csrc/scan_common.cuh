// What the scan bodies (adc_scan.cuh, l2_scan.cuh) share: a launch plan,
// the empty-row write, and the end of a candidate range (a range ends at its
// last valid id, so trailing padding costs no step of the scan).
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace scancommon {

constexpr unsigned kAllLanes = 0xffffffffu;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can opt into

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

// A kernel's launch at some widths: rows a block, its shared memory, and
// blocks resident on an SM.
struct Plan {
  int G = 0;  // 0 when not even the smallest group fits a block
  size_t smem = 0;
  int per_sm = 0;
};

// 16-byte code vectors a row, the ADC scans' NV: 1 when a row's codes are one
// vector (and their base is 16-byte aligned, as a tensor's own storage is),
// else 0.
inline int code_vectors(int m, int code_size, bool aligned = true) {
  return aligned && m * code_size == 16 ? 1 : 0;
}

inline int code_vectors(const void* codes, int m, int code_size) {
  return code_vectors(m, code_size, (reinterpret_cast<uintptr_t>(codes) & 15) == 0);
}

// Write inf / -1 to the k entries of one output row; all 32 lanes call this.
__device__ __forceinline__ void fill_empty(float* __restrict__ d, int* __restrict__ o, int k,
                                           int lane) {
  if ((k & 3) == 0) {
    for (int i = lane; i < k / 4; i += 32) {
      reinterpret_cast<float4*>(d)[i] =
          make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F, CUDART_INF_F);
      reinterpret_cast<int4*>(o)[i] = make_int4(-1, -1, -1, -1);
    }
  } else {
    for (int i = lane; i < k; i += 32) { d[i] = CUDART_INF_F; o[i] = -1; }
  }
}

// The last valid id of [c_lo, c_hi), read as 16-byte vectors from the first
// aligned id on, by the whole block, four loads in flight a thread (c_lo - 1
// where it finds none); the unaligned head goes to warp 0.
__device__ __forceinline__ int head_end(const int* ib, int c_lo, int c_hi) {
  const int skip = (int)((16 - (reinterpret_cast<uintptr_t>(ib + c_lo) & 15)) & 15) / 4;
  return min(c_hi, c_lo + skip);
}

__device__ __forceinline__ int last_valid_head(const int* __restrict__ ib, int c_lo, int c_hi,
                                               int lane) {
  const int c = c_lo + lane;
  const int last = c < head_end(ib, c_lo, c_hi) && __ldg(ib + c) >= 0 ? c : c_lo - 1;
  return __reduce_max_sync(kAllLanes, last);
}

__device__ __forceinline__ int last_valid_body(const int* __restrict__ ib, int c_lo, int c_hi) {
  const int a0 = head_end(ib, c_lo, c_hi);
  const int n4 = (c_hi - a0) / 4;
  const int4* p4 = reinterpret_cast<const int4*>(ib + a0);
  int last = c_lo - 1;
  for (int t0 = threadIdx.x; t0 < n4; t0 += 4 * blockDim.x) {
    int4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int t = t0 + u * blockDim.x;
      v[u] = t < n4 ? __ldg(p4 + t) : make_int4(-1, -1, -1, -1);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = a0 + 4 * (t0 + u * blockDim.x);
      if (v[u].x >= 0) last = max(last, c);
      if (v[u].y >= 0) last = max(last, c + 1);
      if (v[u].z >= 0) last = max(last, c + 2);
      if (v[u].w >= 0) last = max(last, c + 3);
    }
  }
  for (int c = a0 + 4 * n4 + threadIdx.x; c < c_hi; c += blockDim.x)  // the tail
    if (__ldg(ib + c) >= 0) last = max(last, c);
  return last;
}

// One past the last valid id of [c_lo, c_hi) (c_lo when there is none), found
// by every thread of the block together; `slot` is one int of shared memory.
// Two block barriers.
__device__ __forceinline__ int range_end(int* slot, const int* __restrict__ ib, int c_lo,
                                         int c_hi) {
  if (threadIdx.x == 0) *slot = c_lo - 1;
  __syncthreads();
  if (threadIdx.x < 32) atomicMax(slot, last_valid_head(ib, c_lo, c_hi, threadIdx.x));
  atomicMax(slot, last_valid_body(ib, c_lo, c_hi));
  __syncthreads();
  return *slot + 1;
}

}  // namespace scancommon
