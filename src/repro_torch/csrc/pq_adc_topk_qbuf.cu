// Dispatch-buffer ADC scan with a running top-k, for sm_90a.
//
// Replaces the TPU kernel `pq_adc_topk_qbuf` (repro/kernels/pq_adc.py,
// `_pq_adc_topk_qbuf_kernel`). For each bucket b (one local partition) and
// each dispatch slot s whose qbuf[b, s] names a query row r:
//
//   d[n] = sum_m lut_pad[r, m, codes[b, n, m]] + q_off[b, s] + cand_off[b, n]
//
// summed over m in order, then q_off, then cand_off (the TPU kernel's order,
// pq_adc.py:345). There are only additions, so nothing contracts into an FMA
// and the result equals the plain version bit for bit. Candidates with
// ids[b, n] < 0 are masked; the k smallest (d, n) pairs per slot come out
// ascending as (dist, ids[b, n]), inf / -1 where fewer than k are valid. An
// earlier candidate wins an exact tie (topk_list.cuh).
//
// What bounds it on an H100: bytes. The [B, S, k] outputs are written whole
// (empty slots as inf / -1), and the occupied slots' LUT rows, the ids,
// offsets and codes of the used buckets are read once; the lookups are
// m per (occupied slot, valid candidate), a few tens of microseconds of
// shared-memory reads at the serve path's widths.
//
// What this simple design does about it: one block per (bucket, group of G
// dispatch slots), so a hot bucket's occupied slots spread over several
// blocks instead of one; the block runs adc_scan.cuh's body over its bucket
// (the group's LUT rows in shared memory, read by gather; codes in tiles of
// 256 in their store dtype; tiles with no valid id skipped), with
// qbuf == n_rows - 1 as the empty slot, flushed as inf / -1 unscanned. The
// running lists (k = rk = 400 on the serve path) are G x k x 8 bytes of
// shared memory; the launch is refused when not even one slot fits.
// Splitting a bucket's candidates across blocks (as pq_adc_topk.cu does),
// and a faster selection than one insert at a time, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_scan.cuh"

namespace {

using namespace adcscan;

template <typename CT, int G>
__global__ void __launch_bounds__(kThreads)
pq_adc_topk_qbuf_kernel(const float* __restrict__ lut_pad, int n_rows, int m, int ks,
                        const int* __restrict__ qbuf, int S,
                        const CT* __restrict__ codes, const int* __restrict__ ids,
                        const float* __restrict__ cand_off,
                        const float* __restrict__ q_off, int N, int k,
                        float* __restrict__ od, int* __restrict__ oi) {
  extern __shared__ __align__(16) float smem[];
  const int n_groups = (S + G - 1) / G;
  const int b = blockIdx.x / n_groups;
  const int s0 = (blockIdx.x - b * n_groups) * G;
  const size_t slot0 = (size_t)b * S + s0;
  // qbuf == n_rows - 1 is the empty slot
  scan_group<CT, G>(smem, lut_pad, m, ks, qbuf + slot0, 0, min(G, S - s0), n_rows - 1,
                    q_off ? q_off + slot0 : nullptr, codes + (size_t)b * N * m,
                    ids + (size_t)b * N, cand_off ? cand_off + (size_t)b * N : nullptr, 0, N,
                    k, od + slot0 * k, oi + slot0 * k, true);
}

template <typename CT, int G>
int run(const void* lut_pad, int n_rows, int m, int ks, const void* qbuf, int B, int S,
        const void* codes, const void* ids, const void* cand_off, const void* q_off,
        int N, int k, void* od, void* oi, size_t smem, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(pq_adc_topk_qbuf_kernel<CT, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * ((S + G - 1) / G);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  pq_adc_topk_qbuf_kernel<CT, G><<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)lut_pad, n_rows, m, ks, (const int*)qbuf, S, (const CT*)codes,
      (const int*)ids, (const float*)cand_off, (const float*)q_off, N, k, (float*)od,
      (int*)oi);
  return (int)cudaGetLastError();
}

template <typename CT>
int launch(const void* lut_pad, int n_rows, int m, int ks, const void* qbuf, int B, int S,
           const void* codes, const void* ids, const void* cand_off, const void* q_off,
           int N, int k, void* od, void* oi, void* stream) {
  const int G = pick_group(m, ks, k, sizeof(CT));
  const size_t smem = smem_bytes(G, m, ks, k, sizeof(CT));
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  switch (G) {
    case 8: return run<CT, 8>(lut_pad, n_rows, m, ks, qbuf, B, S, codes, ids, cand_off, q_off,
                              N, k, od, oi, smem, stream);
    case 4: return run<CT, 4>(lut_pad, n_rows, m, ks, qbuf, B, S, codes, ids, cand_off, q_off,
                              N, k, od, oi, smem, stream);
    case 2: return run<CT, 2>(lut_pad, n_rows, m, ks, qbuf, B, S, codes, ids, cand_off, q_off,
                              N, k, od, oi, smem, stream);
    default: return run<CT, 1>(lut_pad, n_rows, m, ks, qbuf, B, S, codes, ids, cand_off,
                               q_off, N, k, od, oi, smem, stream);
  }
}

}  // namespace

extern "C" {

// Dispatch slots per block for these widths (8, 4, 2 or 1).
int pq_adc_topk_qbuf_group(int m, int ks, int k, int code_size) {
  return pick_group(m, ks, k, code_size);
}

// Shared memory one block needs at that group size, in bytes; above 232448
// the launch is refused.
long long pq_adc_topk_qbuf_smem_bytes(int m, int ks, int k, int code_size) {
  return (long long)smem_bytes(pick_group(m, ks, k, code_size), m, ks, k, code_size);
}

// lut_pad [n_rows, m, ks] f32, qbuf [B, S] int32, codes [B, N, m] uint8 or
// uint16, ids [B, N] int32, cand_off [B, N] f32 or NULL, q_off [B, S] f32 or
// NULL -> od [B, S, k] f32, oi [B, S, k] int32. Returns a cudaError_t.
int pq_adc_topk_qbuf_u8(const void* lut_pad, int n_rows, int m, int ks, const void* qbuf,
                        int B, int S, const void* codes, const void* ids,
                        const void* cand_off, const void* q_off, int N, int k, void* od,
                        void* oi, void* stream) {
  return launch<uint8_t>(lut_pad, n_rows, m, ks, qbuf, B, S, codes, ids, cand_off, q_off, N,
                         k, od, oi, stream);
}

int pq_adc_topk_qbuf_u16(const void* lut_pad, int n_rows, int m, int ks, const void* qbuf,
                         int B, int S, const void* codes, const void* ids,
                         const void* cand_off, const void* q_off, int N, int k, void* od,
                         void* oi, void* stream) {
  return launch<uint16_t>(lut_pad, n_rows, m, ks, qbuf, B, S, codes, ids, cand_off, q_off, N,
                          k, od, oi, stream);
}

}  // extern "C"
