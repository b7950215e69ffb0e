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
// What the design does about it:
//  * the block body is adc_scan.cuh's, as in the dispatch-buffer scan, with
//    an identity row map that marks no row empty: a block takes G query rows
//    (row b*Q + q: every row is scanned, the last one included), one warp
//    each, and one range of its bucket's candidates; each warp reads 16-byte
//    code rows straight into registers and keeps its row's k smallest with a
//    bulk selection (topk_select.cuh): the batched scan's rows each see
//    their bucket's ~1,000 candidates against k = 400, most of which enter;
//  * one bucket with few row groups (the flat scan: 1,000 queries) is split
//    along N into `splits` ranges of whole tiles of 256, so the grid fills
//    the card; each block writes a partial list of (dist, position) per row
//    and topk_merge.cuh merges them under the same key, so a lower position
//    still wins an exact tie; with one split the scan writes ids directly;
//  * the row groups of one range are the fastest grid index, so blocks in
//    flight together read the same codes from the card's L2.
// The flat scan is bound by its gathers, not its selection: once a row's
// list is full, few of its candidates beat the k-th key. The gathers' bank
// conflicts are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_scan.cuh"
#include "topk_merge.cuh"

namespace {

using namespace adcscan;
using topkmerge::merge_smem;

constexpr int kTileN = 256;  // the unit a candidate range is cut in

template <typename CT, int NV>
__global__ void __launch_bounds__(32 * kMaxGroup)
pq_adc_topk_scan_kernel(const float* __restrict__ lut, int Q, int m, int ks,
                        const CT* __restrict__ codes, const int* __restrict__ ids,
                        const float* __restrict__ cand_off, const float* __restrict__ q_off,
                        int N, int k, int splits, float* __restrict__ od,
                        int* __restrict__ oi) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = blockDim.x / 32;
  const int s0 = blockIdx.x * G, split = blockIdx.y, b = blockIdx.z;
  // this split's candidates: a whole number of tiles
  const long long tiles = (N + kTileN - 1) / kTileN;
  const int c_lo = (int)min((long long)N, tiles * split / splits * kTileN);
  const int c_hi = (int)min((long long)N, tiles * (split + 1) / splits * kTileN);
  const size_t row0 = (size_t)b * Q + s0;
  // rows of [B, splits, Q, k]: ids when there is one split, else positions
  const size_t out0 = (((size_t)b * splits + split) * Q + s0) * k;
  scan_group<CT, NV>(smem, lut, m, ks, nullptr, row0, min(G, Q - s0), 0x7fffffff,
                      q_off ? q_off + row0 : nullptr, codes + (size_t)b * N * m,
                      ids + (size_t)b * N, cand_off ? cand_off + (size_t)b * N : nullptr, c_lo,
                      c_hi, k, od + out0, oi + out0, splits == 1);
}

// The launch plan of the scan kernel that codes of this width take.
template <typename CT>
Plan plan_for(int nv, int m, int ks, int k) {
  return nv ? plan(pq_adc_topk_scan_kernel<CT, 1>, m, ks, k) : plan(pq_adc_topk_scan_kernel<CT, 0>, m, ks, k);
}

Plan plan_for(int code_size, int m, int ks, int k) {
  const int nv = code_vectors(m, code_size);
  return code_size == 2 ? plan_for<uint16_t>(nv, m, ks, k) : plan_for<uint8_t>(nv, m, ks, k);
}

// Enough ranges that the blocks fill every SM's places at least once, at
// least two tiles a range; 1 when the row groups fill the card, no block fits
// or the merge's lists do not.
int splits_for(const Plan& p, int B, int Q, int N, int k) {
  int dev = 0, sms = 0;
  if (p.G == 0 || merge_smem(k) > kMaxSmem || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  const long long groups = (long long)B * ((Q + p.G - 1) / p.G);
  const long long tiles = ((long long)N + kTileN - 1) / kTileN;
  const long long slots = (long long)p.per_sm * sms;
  long long splits = groups > 0 ? (slots + groups - 1) / groups : 1;
  if (splits > tiles / 2) splits = tiles / 2;
  return splits > 1 ? (int)splits : 1;
}

template <typename CT>
int launch(const void* lut, int B, int Q, int m, int ks, const void* codes, const void* ids,
           const void* cand_off, const void* q_off, int N, int k, int splits, void* pd,
           void* pc, void* od, void* oi, void* stream) {
  const int nv = code_vectors(codes, m, sizeof(CT));
  const Plan p = plan_for<CT>(nv, m, ks, k);
  if (p.G == 0 || (splits > 1 && merge_smem(k) > kMaxSmem) || splits < 1)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Q == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  auto kernel = nv ? pq_adc_topk_scan_kernel<CT, 1> : pq_adc_topk_scan_kernel<CT, 0>;
  const dim3 grid((Q + p.G - 1) / p.G, splits, B);
  kernel<<<grid, 32 * p.G, p.smem, st>>>(
      (const float*)lut, Q, m, ks, (const CT*)codes, (const int*)ids, (const float*)cand_off,
      (const float*)q_off, N, k, splits, splits == 1 ? (float*)od : (float*)pd,
      splits == 1 ? (int*)oi : (int*)pc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)topkmerge::merge((const float*)pd, (const int*)pc, (const int*)ids, B, Q, N, k,
                               splits, (float*)od, (int*)oi, st);
}

}  // namespace

extern "C" {

// Shared memory one scan block needs at these widths, in bytes (one row's
// when none fits); above 232448 the launch is refused.
long long pq_adc_topk_smem_bytes(int m, int ks, int k, int code_size) {
  const int G = plan_for(code_size, m, ks, k).G;
  return (long long)smem_bytes(G > 0 ? G : 1, m, ks, k);
}

// Candidate ranges each of B code sets of N rows is split into for Q query
// rows each, on the current device (splits_for), for codes whose base is
// 16-byte aligned.
int pq_adc_topk_splits(int B, int Q, int N, int m, int ks, int k, int code_size) {
  return splits_for(plan_for(code_size, m, ks, k), B, Q, N, k);
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
