// A running top-k kept by one warp as a sorted list in shared memory, for the
// L2 scans (l2_scan.cuh); the ADC scans and the split scans' merge select in
// bulk instead (topk_select.cuh).
//
// Keys are (dist, candidate index) in lexicographic order, so an earlier
// candidate wins an exact tie, as on the TPU, where the running list precedes
// each new block (repro/kernels/l2_topk.py:232); ids then agree with a
// lowest-index-first top-k.
#pragma once

#include <cuda_runtime.h>

constexpr unsigned kFull = 0xffffffffu;

// (dist, candidate index) lexicographic order
__device__ __forceinline__ bool key_less(float da, int ca, float db, int cb) {
  return da < db || (da == db && ca < cb);
}

// Insert (nd, nc) into the ascending list (Ld, Lc) of length len <= k. The
// caller guarantees the key beats the k-th entry when the list is full. All
// 32 lanes of the warp call this together.
__device__ __forceinline__ void list_insert(float* Ld, int* Lc, int& len, int k,
                                            float nd, int nc, int lane) {
  int p = 0;
  for (int base = 0; base < len; base += 32) {
    int i = base + lane;
    bool less = i < len && key_less(Ld[i], Lc[i], nd, nc);
    p += __popc(__ballot_sync(kFull, less));
  }
  // shift [p, last) one place right, top chunk first so nothing is overwritten
  const int last = min(len, k - 1);
  for (int base = (last - 1) & ~31; base >= (p & ~31) && last > 0; base -= 32) {
    int i = base + lane;
    bool mv = i >= p && i < last;
    float v = 0.f;
    int c = 0;
    if (mv) { v = Ld[i]; c = Lc[i]; }
    __syncwarp();
    if (mv) { Ld[i + 1] = v; Lc[i + 1] = c; }
    __syncwarp();
  }
  if (lane == 0) { Ld[p] = nd; Lc[p] = nc; }
  __syncwarp();
  len = min(len + 1, k);
}

// Offer the 32 lanes' candidates (dist, c), those with ok set, to the list
// in lane order: each that beats the k-th key (td, tc) is inserted, and the
// k-th key is refreshed once the list is full.
__device__ __forceinline__ void list_offer(float* Ld, int* Lc, int& len, int k,
                                           float& td, int& tc, bool ok, float dist,
                                           int c, int lane) {
  unsigned pend = __ballot_sync(kFull, ok && (len < k || key_less(dist, c, td, tc)));
  while (pend) {
    const int src = __ffs(pend) - 1;
    const float nd = __shfl_sync(kFull, dist, src);
    const int nc = __shfl_sync(kFull, c, src);
    list_insert(Ld, Lc, len, k, nd, nc, lane);
    if (len == k) { td = Ld[k - 1]; tc = Lc[k - 1]; }
    pend &= ~(1u << src);
    pend &= __ballot_sync(kFull, ok && (len < k || key_less(dist, c, td, tc)));
  }
}
