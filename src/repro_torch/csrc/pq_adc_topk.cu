// Flat and batched ADC scans with a running top-k, for sm_90a.
//
// Replaces the TPU kernels `pq_adc_topk` and `pq_adc_topk_batched`
// (repro/kernels/pq_adc.py, `_pq_adc_topk_kernel`,
// `_pq_adc_topk_batched_kernel`): for every query row q of bucket b,
//
//   d[n] = sum_m lut[b, q, m, codes[b, n, m]] + q_off[b, q] + cand_off[b, n]
//
// (an offset given as NULL adds nothing), and the k smallest (d, n) over the
// candidates with ids[b, n] >= 0, ascending as (dist, ids[b, n]), inf / -1
// past the valid ones. The flat form is one bucket. The sum runs over m in
// order, then q_off, then cand_off, with additions only, so the result
// equals the plain version bit for bit; an earlier candidate wins an exact
// tie.
//
// What bounds it on an H100: for the flat scan of 1,000 queries over 1M
// codes, operations, (m - 1) additions per (query, valid candidate) at the
// f32 rate, each next to a shared-memory gather; reading the LUTs and codes
// is ~32 MB. For the batched scan at the serve path's widths, bytes: the
// [B, Q, m, ks] LUTs (2.15 GB) and the [B, Q, k] outputs.
//
// What this simple design does about it:
//  * the block body is adc_scan.cuh's, as in the dispatch-buffer scan, with
//    an identity row map that marks no row empty: a block takes G query rows
//    (row b*Q + q: every row is scanned, the last one included) and one range
//    of its bucket's candidates;
//  * one bucket with a few row groups (the flat scan: 1,000 queries are 125
//    groups of 8, fewer than the card's 132 SMs) is split along N into
//    `splits` ranges of whole tiles, so the grid fills the card; each block
//    writes a partial list of (dist, position) per row and topk_merge.cuh
//    merges them under the same key, so a lower position still wins an exact
//    tie; with one split the scan writes ids directly;
//  * the row groups of one range are the fastest grid index, so blocks in
//    flight together read the same code tiles from the card's L2.
// A faster selection than one insert at a time, and a gather with fewer bank
// conflicts, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_scan.cuh"
#include "topk_merge.cuh"

namespace {

using namespace adcscan;
using topkmerge::merge_smem;

template <typename CT, int G>
__global__ void __launch_bounds__(kThreads)
pq_adc_topk_scan_kernel(const float* __restrict__ lut, int Q, int m, int ks,
                        const CT* __restrict__ codes, const int* __restrict__ ids,
                        const float* __restrict__ cand_off, const float* __restrict__ q_off,
                        int N, int k, int splits, float* __restrict__ od,
                        int* __restrict__ oi) {
  extern __shared__ __align__(16) float smem[];
  const int s0 = blockIdx.x * G, split = blockIdx.y, b = blockIdx.z;
  // this split's candidates: a whole number of tiles
  const long long tiles = (N + kTileN - 1) / kTileN;
  const int c_lo = (int)min((long long)N, tiles * split / splits * kTileN);
  const int c_hi = (int)min((long long)N, tiles * (split + 1) / splits * kTileN);
  const size_t row0 = (size_t)b * Q + s0;
  // rows of [B, splits, Q, k]: ids when there is one split, else positions
  const size_t out0 = (((size_t)b * splits + split) * Q + s0) * k;
  scan_group<CT, G>(smem, lut, m, ks, nullptr, row0, min(G, Q - s0), 0x7fffffff,
                    q_off ? q_off + row0 : nullptr, codes + (size_t)b * N * m,
                    ids + (size_t)b * N, cand_off ? cand_off + (size_t)b * N : nullptr, c_lo,
                    c_hi, k, od + out0, oi + out0, splits == 1);
}

template <typename CT, int G>
cudaError_t scan(const void* lut, int B, int Q, int m, int ks, const void* codes,
                 const void* ids, const void* cand_off, const void* q_off, int N, int k,
                 int splits, void* od, void* oi, size_t smem, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(pq_adc_topk_scan_kernel<CT, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Q + G - 1) / G, splits, B);
  pq_adc_topk_scan_kernel<CT, G><<<grid, kThreads, smem, st>>>(
      (const float*)lut, Q, m, ks, (const CT*)codes, (const int*)ids, (const float*)cand_off,
      (const float*)q_off, N, k, splits, (float*)od, (int*)oi);
  return cudaGetLastError();
}

template <typename CT, int G>
int blocks_per_sm(size_t smem) {
  int per_sm = 0;
  if (cudaFuncSetAttribute(pq_adc_topk_scan_kernel<CT, G>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pq_adc_topk_scan_kernel<CT, G>,
                                                    kThreads, smem) != cudaSuccess)
    return 0;
  return per_sm;
}

template <typename CT>
int splits_for(int B, int Q, int N, int m, int ks, int k) {
  const int G = pick_group(m, ks, k, sizeof(CT));
  const size_t smem = smem_bytes(G, m, ks, k, sizeof(CT));
  int dev = 0, sms = 0;
  if (smem > kMaxSmem || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  int per_sm;
  switch (G) {
    case 8: per_sm = blocks_per_sm<CT, 8>(smem); break;
    case 4: per_sm = blocks_per_sm<CT, 4>(smem); break;
    case 2: per_sm = blocks_per_sm<CT, 2>(smem); break;
    default: per_sm = blocks_per_sm<CT, 1>(smem);
  }
  const long long groups = (long long)B * ((Q + G - 1) / G);
  const long long tiles = ((long long)N + kTileN - 1) / kTileN;
  const long long slots = (long long)per_sm * sms;
  // enough ranges that the blocks fill every SM's places at least once
  long long splits = groups > 0 ? (slots + groups - 1) / groups : 1;
  if (splits > tiles / 2) splits = tiles / 2;
  return splits > 1 ? (int)splits : 1;
}

template <typename CT>
int launch(const void* lut, int B, int Q, int m, int ks, const void* codes, const void* ids,
           const void* cand_off, const void* q_off, int N, int k, int splits, void* pd,
           void* pc, void* od, void* oi, void* stream) {
  const int G = pick_group(m, ks, k, sizeof(CT));
  const size_t smem = smem_bytes(G, m, ks, k, sizeof(CT));
  if (smem > kMaxSmem || (splits > 1 && merge_smem(k) > kMaxSmem) || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Q == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  void* sd = splits == 1 ? od : pd;
  void* si = splits == 1 ? oi : pc;
  cudaError_t err;
  switch (G) {
    case 8: err = scan<CT, 8>(lut, B, Q, m, ks, codes, ids, cand_off, q_off, N, k, splits, sd, si,
                              smem, st); break;
    case 4: err = scan<CT, 4>(lut, B, Q, m, ks, codes, ids, cand_off, q_off, N, k, splits, sd, si,
                              smem, st); break;
    case 2: err = scan<CT, 2>(lut, B, Q, m, ks, codes, ids, cand_off, q_off, N, k, splits, sd, si,
                              smem, st); break;
    default: err = scan<CT, 1>(lut, B, Q, m, ks, codes, ids, cand_off, q_off, N, k, splits, sd,
                               si, smem, st);
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)topkmerge::merge((const float*)pd, (const int*)pc, (const int*)ids, B, Q, N, k,
                               splits, (float*)od, (int*)oi, st);
}

}  // namespace

extern "C" {

// Shared memory one scan block needs at these widths, in bytes; above 232448
// the launch is refused.
long long pq_adc_topk_smem_bytes(int m, int ks, int k, int code_size) {
  return (long long)smem_bytes(pick_group(m, ks, k, code_size), m, ks, k, code_size);
}

// Candidate ranges each of B code sets of N rows is split into for Q query
// rows each, on the current device: as many as fill every SM's places with
// blocks when the row groups alone do not, at least two tiles of 256 a
// range; 1 when the groups fill the card or no block fits.
int pq_adc_topk_splits(int B, int Q, int N, int m, int ks, int k, int code_size) {
  return code_size == 2 ? splits_for<uint16_t>(B, Q, N, m, ks, k)
                        : splits_for<uint8_t>(B, Q, N, m, ks, k);
}

// lut [B, Q, m, ks] f32, codes [B, N, m] uint8 or uint16, ids [B, N] int32,
// cand_off [B, N] f32 or NULL, q_off [B, Q] f32 or NULL -> od [B, Q, k] f32,
// oi [B, Q, k] int32; with splits > 1, pd / pc [B, splits, Q, k] (f32,
// int32) hold the partial lists. Returns a cudaError_t.
int pq_adc_topk_u8(const void* lut, int B, int Q, int m, int ks, const void* codes,
                   const void* ids, const void* cand_off, const void* q_off, int N, int k,
                   int splits, void* pd, void* pc, void* od, void* oi, void* stream) {
  return launch<uint8_t>(lut, B, Q, m, ks, codes, ids, cand_off, q_off, N, k, splits, pd, pc,
                         od, oi, stream);
}

int pq_adc_topk_u16(const void* lut, int B, int Q, int m, int ks, const void* codes,
                    const void* ids, const void* cand_off, const void* q_off, int N, int k,
                    int splits, void* pd, void* pc, void* od, void* oi, void* stream) {
  return launch<uint16_t>(lut, B, Q, m, ks, codes, ids, cand_off, q_off, N, k, splits, pd, pc,
                          od, oi, stream);
}

}  // extern "C"
