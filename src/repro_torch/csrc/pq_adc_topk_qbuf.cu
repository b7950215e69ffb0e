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
// What this simple design does about it:
//  * one block per (bucket, group of G dispatch slots): a hot bucket's
//    occupied slots spread over several blocks instead of one. Each block
//    tests its own slots (qbuf == n_rows - 1 is empty) and flushes the empty
//    ones as inf / -1; a group with no occupied slot does nothing else;
//  * the group's LUT rows (G x m x ks x 4 bytes, 16 KB a slot at m = 16,
//    ks = 256) sit in shared memory and are read by gather; G is the largest
//    of 8, 4, 2, 1 whose shared memory fits in the 227 KB a block can opt
//    into, and the launch is refused when not even one slot fits;
//  * candidates go in tiles of 256, one per thread; a tile's codes are read
//    coalesced in their store dtype (uint8 or uint16, never widened) and
//    kept transposed in shared memory; tiles with no valid id are skipped;
//  * each thread sums its candidate's distance for all G slots in
//    registers; then warp w keeps slot w's running list (k = rk = 400 on the
//    serve path, G x k x 8 bytes) in shared memory.
// Splitting a bucket's candidates across blocks, and a faster selection
// than one insert at a time, are later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "topk_list.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = kThreads;     // candidates per tile, one per thread
constexpr int kMaxGroup = kWarps;    // one warp keeps one slot's list
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can opt into

size_t smem_bytes(int G, int m, int ks, int k, int code_size) {
  return 4 * ((size_t)G * m * ks      // lut_s: the group's LUT rows
              + (size_t)G * kTileN     // dt: distance tile
              + 2 * (size_t)G * k      // Ld, Lc: running lists
              + kTileN                 // cid
              + 3 * (size_t)G + 1)     // occ_slot, occ_row, qo, n_occ
         + (size_t)m * kTileN * code_size;  // codes_s: transposed code tile
}

int pick_group(int m, int ks, int k, int code_size) {
  int G = kMaxGroup;
  while (G > 1 && smem_bytes(G, m, ks, k, code_size) > kMaxSmem) G >>= 1;
  return G;
}

template <typename CT, int G>
__global__ void __launch_bounds__(kThreads)
pq_adc_topk_qbuf_kernel(const float* __restrict__ lut_pad, int n_rows, int m, int ks,
                        const int* __restrict__ qbuf, int S,
                        const CT* __restrict__ codes, const int* __restrict__ ids,
                        const float* __restrict__ cand_off,
                        const float* __restrict__ q_off, int N, int k,
                        float* __restrict__ od, int* __restrict__ oi) {
  extern __shared__ __align__(16) float smem[];
  const int mks = m * ks;
  float* lut_s = smem;
  float* dt = lut_s + (size_t)G * mks;
  float* Ld = dt + G * kTileN;
  int* Lc = reinterpret_cast<int*>(Ld + (size_t)G * k);
  int* cid = Lc + (size_t)G * k;
  int* occ_slot = cid + kTileN;
  int* occ_row = occ_slot + G;
  float* qo = reinterpret_cast<float*>(occ_row + G);
  int* n_occ_s = reinterpret_cast<int*>(qo + G);
  CT* codes_s = reinterpret_cast<CT*>(n_occ_s + 1);

  const int n_groups = (S + G - 1) / G;
  const int b = blockIdx.x / n_groups;
  const int s0 = (blockIdx.x - b * n_groups) * G;
  const int ns = min(G, S - s0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int empty_row = n_rows - 1;
  const int* qb = qbuf + (size_t)b * S + s0;
  const CT* cb = codes + (size_t)b * N * m;
  const int* ib = ids + (size_t)b * N;
  const float* cob = cand_off ? cand_off + (size_t)b * N : nullptr;
  float* odb = od + ((size_t)b * S + s0) * k;
  int* oib = oi + ((size_t)b * S + s0) * k;

  // the group's occupied slots, in slot order; empty slots flush as inf / -1
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < ns; ++i) {
      const int r = qb[i];
      if (r >= 0 && r < empty_row) {
        occ_slot[n] = i;
        occ_row[n] = r;
        qo[n] = q_off ? q_off[(size_t)b * S + s0 + i] : 0.f;
        ++n;
      }
    }
    *n_occ_s = n;
  }
  for (int e = tid; e < ns * k; e += kThreads) {
    const int r = qb[e / k];
    if (!(r >= 0 && r < empty_row)) { odb[e] = CUDART_INF_F; oib[e] = -1; }
  }
  __syncthreads();
  const int n_occ = *n_occ_s;
  if (n_occ == 0) return;

  for (int i = 0; i < n_occ; ++i) {
    const float* src = lut_pad + (size_t)occ_row[i] * mks;
    for (int e = tid; e < mks; e += kThreads) lut_s[(size_t)i * mks + e] = src[e];
  }

  // warp w keeps the list of occupied slot w; (td, tc) is its k-th key
  float* Lds = Ld + (size_t)warp * k;
  int* Lcs = Lc + (size_t)warp * k;
  int len = 0;
  float td = CUDART_INF_F;
  int tc = 0;

  for (int c0 = 0; c0 < N; c0 += kTileN) {
    const int c = c0 + tid;
    const int id = c < N ? ib[c] : -1;
    cid[tid] = id;
    if (!__syncthreads_or(id >= 0)) continue;  // no valid candidate in this tile

    const int nt = min(kTileN, N - c0);
    const CT* ct = cb + (size_t)c0 * m;
    for (int e = tid; e < nt * m; e += kThreads) {
      const int t = e / m, j = e - t * m;
      codes_s[j * kTileN + t] = ct[e];
    }
    __syncthreads();

    if (id >= 0) {
      float acc[G];
      {
        const int code = codes_s[tid];
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] = lut_s[(size_t)g * mks + code];
      }
      for (int j = 1; j < m; ++j) {
        const int code = codes_s[j * kTileN + tid];
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g] += lut_s[(size_t)g * mks + j * ks + code];
      }
      const float co = cob ? cob[c] : 0.f;
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float v = acc[g];
        if (q_off) v += qo[g];
        if (cob) v += co;
        dt[g * kTileN + tid] = v;
      }
    }
    __syncthreads();

    if (warp < n_occ) {
      for (int h = 0; h < nt; h += 32) {
        const int cl = h + lane;
        const bool ok = cl < nt && cid[cl] >= 0;
        const float dist = ok ? dt[warp * kTileN + cl] : 0.f;
        list_offer(Lds, Lcs, len, k, td, tc, ok, dist, c0 + cl, lane);
      }
    }
    __syncthreads();
  }

  // flush the occupied slots; unfilled places are inf / -1
  if (warp < n_occ) {
    const size_t o = (size_t)occ_slot[warp] * k;
    for (int i = lane; i < k; i += 32) {
      if (i < len) {
        odb[o + i] = Lds[i];
        oib[o + i] = ib[Lcs[i]];
      } else {
        odb[o + i] = CUDART_INF_F;
        oib[o + i] = -1;
      }
    }
  }
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
