// The merge of partial top-k lists, shared by the split scans (l2_topk.cu,
// pq_adc_topk.cu; l2_topk_qbuf.cu merges in its scan kernel with
// offer_list): a scan split along its candidates writes, per row and range,
// a list of (dist, position) pairs; this kernel merges a row's lists, one
// warp per row, with the bulk selection of topk_select.cuh under the same
// (dist, position) key, so a lower position still wins an exact tie, and
// writes the ids (-1 beside a distance that is not finite, as the plain
// versions).
#pragma once

#include <cuda_runtime.h>

#include "topk_select.cuh"

namespace topkmerge {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Shared memory one merge block needs, in bytes.
inline size_t merge_smem(int k) { return (size_t)kWarps * topksel::row_bytes(k); }

// Offer one partial list (pd, pc [k], positions < 0 unfilled) to a warp's
// selection. The loads go to L2 (__ldcg), so a list another block wrote
// in the same kernel, before a fence, is read as written.
__device__ __forceinline__ void offer_list(topksel::Selector& sel, const float* pd,
                                           const int* pc, int k, int lane) {
  for (int h = 0; h < k; h += 32) {
    const int i = h + lane;
    const int c = i < k ? __ldcg(pc + i) : -1;
    const float dist = i < k ? __ldcg(pd + i) : 0.f;
    sel.offer(c >= 0, topksel::pack(dist, c), lane);
  }
}

// One warp per (bucket, query) row: merge its `splits` partial lists
// (pd, pc [B, splits, Q, k], positions < 0 unfilled) into od / oi [B, Q, k],
// the id of position c being ids[b * C + c].
__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* __restrict__ pd, const int* __restrict__ pc,
                  const int* __restrict__ ids, int B, int Q, int C, int k, int splits,
                  float* __restrict__ od, int* __restrict__ oi) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kWarps + warp;  // b * Q + query
  if (row >= (long long)B * Q) return;  // the whole warp leaves together
  const int b = (int)(row / Q), qi = (int)(row % Q);
  topksel::Selector sel;
  sel.init(smem + warp * topksel::row_bytes(k), k);
  for (int s = 0; s < splits; ++s) {
    const size_t base = (((size_t)b * splits + s) * Q + qi) * k;
    offer_list(sel, pd + base, pc + base, k, lane);
  }
  sel.flush(lane);
  sel.store(od + row * k, oi + row * k, ids + (size_t)b * C, lane);
}

// Launch the merge on `stream`; returns a cudaError_t.
inline cudaError_t merge(const float* pd, const int* pc, const int* ids, int B, int Q, int C,
                         int k, int splits, float* od, int* oi, cudaStream_t stream) {
  const size_t smem = merge_smem(k);
  cudaError_t err = cudaFuncSetAttribute(topk_merge_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long rows = (long long)B * Q;
  topk_merge_kernel<<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, smem, stream>>>(
      pd, pc, ids, B, Q, C, k, splits, od, oi);
  return cudaGetLastError();
}

}  // namespace topkmerge
