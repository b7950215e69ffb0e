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
// earlier candidate wins an exact tie (topk_select.cuh).
//
// What bounds it on an H100: bytes. The [B, S, k] outputs are written whole
// (empty slots as inf / -1), and the occupied slots' LUT rows, the ids,
// offsets and codes of the used buckets are read once; the lookups are
// m per (occupied slot, valid candidate), a few tens of microseconds of
// shared-memory reads at the serve path's widths. What keeps it from that
// bound is each occupied row's work: its gathers, and keeping the k = rk
// smallest of ~1,000 candidates (k = 400 on the serve path, 1,600 at
// rerank 16).
//
// What the design does about it: one block per (group of G dispatch slots,
// bucket), so a hot bucket's occupied slots spread over several blocks; the
// slot groups are the slowest grid index, so the blocks that hold the
// buckets' first slots, where the dispatch puts its queries, run first and
// the empty ones after. A block runs adc_scan.cuh's body over its bucket:
// one warp a slot, which keeps its own LUT row, list and buffer and reads
// 16-byte code rows straight into registers; a bulk selection (filter
// against the k-th key, sort and merge in bulks of 256) in place of one
// insert at a time (topk_select.cuh). qbuf == n_rows - 1 is the empty slot:
// its warp writes inf / -1 and, when the whole group is empty, the block
// leaves without reading anything else. G is the occupancy calculator's
// choice unless the caller names one (the autotuner, kernels/autotune.py).
// The launch is refused when not even one slot fits a block's shared memory,
// or when the G named does not.

#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_scan.cuh"

namespace {

using namespace adcscan;

template <typename CT, int NV>
__global__ void __launch_bounds__(32 * kMaxGroup)
pq_adc_topk_qbuf_kernel(const float* __restrict__ lut_pad, int n_rows, int m, int ks,
                        const int* __restrict__ qbuf, int B, int S,
                        const CT* __restrict__ codes, const int* __restrict__ ids,
                        const float* __restrict__ cand_off,
                        const float* __restrict__ q_off, int N, int k,
                        float* __restrict__ od, int* __restrict__ oi) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = blockDim.x / 32;
  const int b = blockIdx.x % B;
  const int s0 = (blockIdx.x / B) * G;
  const size_t slot0 = (size_t)b * S + s0;
  // qbuf == n_rows - 1 is the empty slot
  scan_group<CT, NV>(smem, lut_pad, m, ks, qbuf + slot0, 0, min(G, S - s0), n_rows - 1,
                      q_off ? q_off + slot0 : nullptr, codes + (size_t)b * N * m,
                      ids + (size_t)b * N, cand_off ? cand_off + (size_t)b * N : nullptr, 0, N,
                      k, od + slot0 * k, oi + slot0 * k);
}

// The launch plan of the kernel that codes of this width take; G = 0 the
// occupancy calculator's choice, else that group alone.
template <typename CT>
Plan plan_for(int nv, int m, int ks, int k, int G) {
  return nv ? plan(pq_adc_topk_qbuf_kernel<CT, 1>, m, ks, k, G)
            : plan(pq_adc_topk_qbuf_kernel<CT, 0>, m, ks, k, G);
}

Plan plan_for(int code_size, int m, int ks, int k, int G) {
  const int nv = code_vectors(m, code_size);
  return code_size == 2 ? plan_for<uint16_t>(nv, m, ks, k, G)
                         : plan_for<uint8_t>(nv, m, ks, k, G);
}

template <typename CT>
int launch(const void* lut_pad, int n_rows, int m, int ks, const void* qbuf, int B, int S,
           const void* codes, const void* ids, const void* cand_off, const void* q_off,
           int N, int k, int G, void* od, void* oi, void* stream) {
  const int nv = code_vectors(codes, m, sizeof(CT));
  const Plan p = plan_for<CT>(nv, m, ks, k, G);
  if (p.G == 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const long long blocks = (long long)B * ((S + p.G - 1) / p.G);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto kernel = nv ? pq_adc_topk_qbuf_kernel<CT, 1> : pq_adc_topk_qbuf_kernel<CT, 0>;
  kernel<<<(unsigned)blocks, 32 * p.G, p.smem, (cudaStream_t)stream>>>(
      (const float*)lut_pad, n_rows, m, ks, (const int*)qbuf, B, S, (const CT*)codes,
      (const int*)ids, (const float*)cand_off, (const float*)q_off, N, k, (float*)od,
      (int*)oi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch at these widths on the current device, for codes of
// code_size bytes whose base is 16-byte aligned: dispatch slots a block (1 to
// 8; 0 when one slot's LUT, list and buffer exceed a block's shared memory),
// the shared memory a block needs (one slot's when none fits; above 232448
// the launch is refused), and blocks resident on an SM.
int pq_adc_topk_qbuf_group(int m, int ks, int k, int code_size) {
  return plan_for(code_size, m, ks, k, 0).G;
}

long long pq_adc_topk_qbuf_smem_bytes(int m, int ks, int k, int code_size) {
  const int G = plan_for(code_size, m, ks, k, 0).G;
  return (long long)smem_bytes(G > 0 ? G : 1, m, ks, k);
}

int pq_adc_topk_qbuf_blocks_per_sm(int m, int ks, int k, int code_size) {
  return plan_for(code_size, m, ks, k, 0).per_sm;
}

// The launch with G slots a block named (1 to 8): out[0] G, or 0 when that
// group does not fit a block, out[1] the shared memory a block of G needs,
// out[2] blocks resident on an SM.
void pq_adc_topk_qbuf_plan_group(int m, int ks, int k, int code_size, int G, long long* out) {
  const Plan p = plan_for(code_size, m, ks, k, G);
  out[0] = p.G;
  out[1] = (long long)smem_bytes(G > 0 ? G : 1, m, ks, k);
  out[2] = p.per_sm;
}

// lut_pad [n_rows, m, ks] f32, qbuf [B, S] int32, codes [B, N, m] uint8 or
// uint16, ids [B, N] int32, cand_off [B, N] f32 or NULL, q_off [B, S] f32 or
// NULL, G the slots a block (0: the calculator's) -> od [B, S, k] f32,
// oi [B, S, k] int32. Returns a cudaError_t.
int pq_adc_topk_qbuf_u8(const void* lut_pad, int n_rows, int m, int ks, const void* qbuf,
                        int B, int S, const void* codes, const void* ids,
                        const void* cand_off, const void* q_off, int N, int k, int G, void* od,
                        void* oi, void* stream) {
  return launch<uint8_t>(lut_pad, n_rows, m, ks, qbuf, B, S, codes, ids, cand_off, q_off, N,
                         k, G, od, oi, stream);
}

int pq_adc_topk_qbuf_u16(const void* lut_pad, int n_rows, int m, int ks, const void* qbuf,
                         int B, int S, const void* codes, const void* ids,
                         const void* cand_off, const void* q_off, int N, int k, int G, void* od,
                         void* oi, void* stream) {
  return launch<uint16_t>(lut_pad, n_rows, m, ks, qbuf, B, S, codes, ids, cand_off, q_off, N,
                          k, G, od, oi, stream);
}

}  // extern "C"
