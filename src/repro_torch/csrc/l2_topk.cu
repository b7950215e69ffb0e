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
// What this simple design does about it:
//  * the chunk body is l2_scan.cuh's, as in the dispatch-buffer scan; a block
//    takes 32 query rows of one bucket (query row b*Q + s: every row is
//    scanned) and one range of its candidates;
//  * one candidate set with a few query chunks (the flat scan: 1,000 queries
//    are 32 chunks, a quarter of the SMs) is split along C into `splits`
//    ranges of whole tiles, so the grid fills the card; each block writes a
//    partial list of (dist, position) per row, and a second kernel
//    (topk_merge.cuh) merges a row's partial lists, one warp per row, under
//    the same (dist, position) key, so a lower position still wins an exact
//    tie; with one split the
//    scan writes ids directly and there is no second pass;
//  * the query chunks of one range are the fastest grid index, so blocks in
//    flight together read the same candidate tiles and the card's 50 MB L2
//    serves the repeats.
// wgmma/TMA and a heap-free selection are later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "l2_scan.cuh"
#include "topk_merge.cuh"

namespace {

using namespace l2scan;
using topkmerge::merge_smem;

template <typename T>
__global__ void __launch_bounds__(kThreads)
l2_topk_scan_kernel(const T* __restrict__ q, int Q, const T* __restrict__ cands,
                    const int* __restrict__ ids, int C, int d, int k, int splits,
                    float* __restrict__ od, int* __restrict__ oi) {
  extern __shared__ __align__(16) float smem[];
  const Chunk ch = carve(smem, d, k);
  const int s0 = blockIdx.x * kSlotChunk, split = blockIdx.y, b = blockIdx.z;
  const int nq = min(kSlotChunk, Q - s0);
  // this split's candidates: a whole number of tiles
  const long long tiles = (C + kTileC - 1) / kTileC;
  const int c_lo = (int)min((long long)C, tiles * split / splits * kTileC);
  const int c_hi = (int)min((long long)C, tiles * (split + 1) / splits * kTileC);
  const int* ib = ids + (size_t)b * C;
  begin_chunk(ch, q + (size_t)b * Q * d, nullptr, (size_t)s0, nq, d);
  scan_range(ch, cands + (size_t)b * C * d, ib, c_lo, c_hi, d, k, nq);
  // rows of [B, splits, Q, k]: ids when there is one split, else positions
  flush_chunk(ch, nq, k, od, oi, nullptr, ((size_t)b * splits + split) * Q + s0,
              splits == 1 ? ib : nullptr);
}

size_t scan_smem(int d, int k) { return chunk_floats(d, k) * sizeof(float); }

template <typename T>
int launch(const void* q, int B, int Q, const void* cands, const void* ids, int C, int d,
           int k, int splits, void* pd, void* pc, void* od, void* oi, void* stream) {
  const size_t smem = scan_smem(d, k), msmem = merge_smem(k);
  if (smem > kMaxSmem || (splits > 1 && msmem > kMaxSmem)) return (int)cudaErrorInvalidValue;
  if (B == 0 || Q == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(l2_topk_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Q + kSlotChunk - 1) / kSlotChunk, splits, B);
  if (splits == 1) {
    l2_topk_scan_kernel<T><<<grid, kThreads, smem, st>>>(
        (const T*)q, Q, (const T*)cands, (const int*)ids, C, d, k, 1, (float*)od, (int*)oi);
    return (int)cudaGetLastError();
  }
  l2_topk_scan_kernel<T><<<grid, kThreads, smem, st>>>(
      (const T*)q, Q, (const T*)cands, (const int*)ids, C, d, k, splits, (float*)pd, (int*)pc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)topkmerge::merge((const float*)pd, (const int*)pc, (const int*)ids, B, Q, C, k,
                               splits, (float*)od, (int*)oi, st);
}

}  // namespace

extern "C" {

// Shared memory a scan block needs, in bytes; above 232448 the launch is
// refused (the merge needs topkmerge::merge_smem(k) bytes).
long long l2_topk_smem_bytes(int d, int k) { return (long long)scan_smem(d, k); }

// Candidate ranges each set is split into on the current device: as many as
// keep every SM's blocks busy in one wave when the query chunks alone do not
// (the flat scan of 1,000 queries is 32 chunks), at least two tiles a range;
// 1 when the chunks fill the card or no block fits.
int l2_topk_splits(int B, int Q, int C, int d, int k) {
  const size_t smem = scan_smem(d, k);
  int dev = 0, sms = 0, per_sm = 0;
  if (smem > kMaxSmem || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaFuncSetAttribute(l2_topk_scan_kernel<float>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, l2_topk_scan_kernel<float>, kThreads,
                                                    smem) != cudaSuccess)
    return 1;
  const long long chunks = (long long)B * ((Q + kSlotChunk - 1) / kSlotChunk);
  const long long tiles = ((long long)C + kTileC - 1) / kTileC;
  long long splits = (long long)per_sm * sms / (chunks > 0 ? chunks : 1);
  if (splits > tiles / 2) splits = tiles / 2;
  return splits > 1 ? (int)splits : 1;
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
