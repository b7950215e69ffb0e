// Flat and batched L2 scans with a running top-k, for sm_90a.
//
// Replaces the TPU kernels `l2_topk` and `l2_topk_batched`
// (repro/kernels/l2_topk.py, `_l2_topk_kernel`, `_l2_topk_batched_kernel`):
// for every query row of bucket b, the k smallest ||q||^2 - 2 q.c + ||c||^2
// over the bucket's candidates with id >= 0, ascending, inf / -1 past the
// valid ones. The flat form is one bucket. An earlier candidate wins an exact
// tie, as on the TPU, where the running list precedes each new block
// (l2_topk.py:53-55).
//
// What bounds it on an H100: 2*d flops per (query, valid candidate) pair at
// the CUDA-core f32 rate (no tensor cores here). For the flat scan of 1,000
// queries against 1M x 128 candidates that is ~3.8 ms; reading the
// candidates once is ~0.15 ms.
//
// What the design does about it:
//  * the block body is l2_scan.cuh's, as in the dispatch-buffer scan, with
//    an identity row map: a block takes G query rows of one bucket (query row
//    b*Q + s: every row is scanned) and one range of its candidates, and keeps
//    each row's k smallest with a bulk selection (topk_select.cuh); G is 16 or
//    32, whichever the occupancy calculator lets an SM hold the most rows of,
//    the larger on a tie (each staged candidate then serves twice the rows;
//    on an H100 the flat scan took 13.6 ms at 32 and 16.2 at 16, PERF.md §6);
//  * one candidate set with few row groups (the flat scan: 1,000 queries) is
//    split along C into `splits` ranges of whole units of 256 candidates, as
//    many as fill every SM's places once from the same plan, so the grid
//    fills the card; each block writes a partial list of (dist, position) per
//    row, and a second kernel (topk_merge.cuh) merges a row's partial lists,
//    one warp per row, under the same (dist, position) key, so a lower
//    position still wins an exact tie; with one split the scan writes ids
//    directly and there is no second pass;
//  * the row groups of one range are the fastest grid index, so blocks in
//    flight together read the same candidate tiles and the card's 50 MB L2
//    serves the repeats.
// Tensor cores (TF32 cannot hold rtol 1e-5) and TMA are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "l2_scan.cuh"
#include "topk_merge.cuh"

namespace {

using namespace l2scan;
using topkmerge::merge_smem;

template <int G, typename T>
__global__ void __launch_bounds__(Shape<G>::kThreads, 32 / G)
l2_topk_scan_kernel(const T* __restrict__ q, int Q, const T* __restrict__ cands,
                    const int* __restrict__ ids, int C, int d, int k, int splits,
                    float* __restrict__ od, int* __restrict__ oi) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int s0 = blockIdx.x * G, split = blockIdx.y, b = blockIdx.z;
  // this split's candidates: a whole number of range units
  const long long units = (C + kRangeUnit - 1) / kRangeUnit;
  const int c_lo = (int)min((long long)C, units * split / splits * kRangeUnit);
  const int c_hi = (int)min((long long)C, units * (split + 1) / splits * kRangeUnit);
  const int* ib = ids + (size_t)b * C;
  const int c_end = scancommon::range_end(reinterpret_cast<int*>(smem), ib, c_lo, c_hi);
  // rows of [B, splits, Q, k]: ids when there is one split, else positions
  scan_group<G, T>(smem, q + (size_t)b * Q * d, false, s0, min(G, Q - s0), d,
                   cands + (size_t)b * C * d, ib, c_lo, c_end, k, od, oi, false,
                   ((size_t)b * splits + split) * Q + s0, splits == 1);
}

template <typename T>
Plan plan_for(int d, int k) {
  return plan(l2_topk_scan_kernel<16, T>, l2_topk_scan_kernel<32, T>, d, k, true);
}

Plan plan_for(int d, int k, int itemsize) {
  return itemsize == 2 ? plan_for<__nv_bfloat16>(d, k) : plan_for<float>(d, k);
}

// Enough ranges that the blocks fill every SM's places once (no more, so no
// second wave starts with a few blocks), at least two units a range; 1 when
// the row groups fill the card, no block fits or the merge's lists do not.
int splits_for(const Plan& p, int B, int Q, int C, int k) {
  int dev = 0, sms = 0;
  if (p.G == 0 || merge_smem(k) > kMaxSmem || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  const long long groups = (long long)B * ((Q + p.G - 1) / p.G);
  const long long units = ((long long)C + kRangeUnit - 1) / kRangeUnit;
  long long splits = groups > 0 ? (long long)p.per_sm * sms / groups : 1;
  if (splits > units / 2) splits = units / 2;
  return splits > 1 ? (int)splits : 1;
}

template <typename T>
int launch(const void* q, int B, int Q, const void* cands, const void* ids, int C, int d,
           int k, int splits, void* pd, void* pc, void* od, void* oi, void* stream) {
  const Plan p = plan_for<T>(d, k);
  if (p.G == 0 || splits < 1 || (splits > 1 && merge_smem(k) > kMaxSmem))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Q == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  auto kernel = p.G == 16 ? l2_topk_scan_kernel<16, T> : l2_topk_scan_kernel<32, T>;
  const dim3 grid((Q + p.G - 1) / p.G, splits, B);
  kernel<<<grid, 16 * p.G, p.smem, st>>>(
      (const T*)q, Q, (const T*)cands, (const int*)ids, C, d, k, splits,
      splits == 1 ? (float*)od : (float*)pd, splits == 1 ? (int*)oi : (int*)pc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)topkmerge::merge((const float*)pd, (const int*)pc, (const int*)ids, B, Q, C, k,
                               splits, (float*)od, (int*)oi, st);
}

}  // namespace

extern "C" {

// The scan's launch at these widths on the current device, for
// `itemsize`-byte elements (4: f32, 2: bf16): query rows a block (16 or 32;
// 0 when a group of 16 exceeds a block's shared memory), the shared memory a
// scan block needs (a group of 16's when none fits; above 232448 the launch
// is refused; the merge needs topkmerge::merge_smem(k) bytes), and blocks
// resident on an SM.
int l2_topk_group(int d, int k, int itemsize) { return plan_for(d, k, itemsize).G; }

long long l2_topk_smem_bytes(int d, int k, int itemsize) {
  return (long long)(plan_for(d, k, itemsize).G == 32 ? smem_bytes<32>(d, k)
                                                      : smem_bytes<16>(d, k));
}

int l2_topk_blocks_per_sm(int d, int k, int itemsize) { return plan_for(d, k, itemsize).per_sm; }

// Candidate ranges each of B sets of C candidates is split into for Q query
// rows each, on the current device (splits_for, from the f32 plan; a bf16
// launch takes the same split).
int l2_topk_splits(int B, int Q, int C, int d, int k) {
  return splits_for(plan_for<float>(d, k), B, Q, C, k);
}

// q [B, Q, d], cands [B, C, d], ids [B, C] int32 -> od [B, Q, k] f32,
// oi [B, Q, k] int32; with splits > 1, pd / pc [B, splits, Q, k] (f32, int32)
// hold the partial lists. Returns a cudaError_t.
int l2_topk_f32(const void* q, int B, int Q, const void* cands, const void* ids, int C, int d,
                int k, int splits, void* pd, void* pc, void* od, void* oi, void* stream) {
  return launch<float>(q, B, Q, cands, ids, C, d, k, splits, pd, pc, od, oi, stream);
}

int l2_topk_bf16(const void* q, int B, int Q, const void* cands, const void* ids, int C, int d,
                 int k, int splits, void* pd, void* pc, void* od, void* oi, void* stream) {
  return launch<__nv_bfloat16>(q, B, Q, cands, ids, C, d, k, splits, pd, pc, od, oi, stream);
}

}  // extern "C"
