// Dispatch-buffer L2 scan with a running top-k, for sm_90a.
//
// Replaces the TPU kernel `l2_topk_qbuf` (repro/kernels/l2_topk.py,
// `_l2_topk_qbuf_kernel`). For each bucket b (one local partition): gather the
// query rows q_pad[qbuf[b, s]] of its occupied dispatch slots, stream the
// partition's candidates, compute ||q||^2 - 2 q.c + ||c||^2 with f32
// accumulation (bf16 stores are upcast with __bfloat162float), mask ids < 0,
// and keep the k smallest (dist, candidate index) pairs per slot. An earlier
// candidate wins an exact tie, as on the TPU (l2_topk.py:232 puts the running
// list before the new block), so ids agree with a lowest-index-first top-k.
//
// What bounds it on an H100: the scan must read the store once,
// B*C*d*itemsize bytes (~0.5 GB for B=1024, C~1000, d=128, f32), and do
// 2*d flops per (occupied slot, valid candidate) pair; at the main path's
// widths the flops dominate (CUDA-core f32, no tensor cores here).
//
// What this simple design does about it:
//  * one block per bucket loads its own qbuf row (the counterpart of scalar
//    prefetch) and skips empty slots (qbuf == n_rows - 1, the sentinel row):
//    they are written as inf / -1 and cost nothing; at the main path most of
//    a bucket's q_cap slots are empty;
//  * occupied slots are scanned 32 at a time, so shared memory stays bounded
//    whatever q_cap is; candidate tiles with no valid id are skipped whole;
//  * each tile of 64 candidates is read from device memory once per 32 slots
//    and kept transposed in shared memory; each thread computes 8 slots x 1
//    candidate with float4 broadcast reads of the query rows;
//  * the running top-k (k = 100 on the main path) does not fit in registers,
//    so it lives in shared memory, 32*k*8 bytes, as a sorted list per slot;
//    one warp owns a slot and inserts the candidates that beat its k-th key
//    (ballot to find them, a warp-wide shift to insert; topk_list.cuh).
//    Shared memory is ~85 KB at d=128, k=100, which needs the dynamic opt-in
//    above 48 KB.
// wgmma/TMA and a heap-free selection are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "topk_list.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlotChunk = 32;   // occupied slots scanned together
constexpr int kTileC = 64;       // candidates per shared-memory tile
constexpr int kSlotsPerThread = kSlotChunk * kTileC / kThreads;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can opt into

static_assert(kSlotChunk * kTileC % kThreads == 0, "tile must split evenly");
static_assert(kThreads / kTileC * kSlotsPerThread == kSlotChunk, "slot groups");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__host__ __device__ inline size_t smem_floats(int S, int d, int k) {
  const size_t d4 = (size_t)((d + 3) & ~3);
  return kSlotChunk * d4            // qs: query rows, f32
         + kSlotChunk               // qsq
         + d4 * (kTileC + 1)        // candT: transposed tile
         + kTileC                   // cid
         + (size_t)kSlotChunk * kTileC  // dt: distance tile
         + 2 * (size_t)kSlotChunk * k   // Ld, Lc: running lists
         + kSlotChunk               // Llen
         + 2 * (size_t)S            // occ, occ_row
         + 1;                       // n_occ
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
l2_topk_qbuf_kernel(const T* __restrict__ q_pad, int n_rows,
                    const int* __restrict__ qbuf, int S,
                    const T* __restrict__ cands, const int* __restrict__ ids,
                    int C, int d, int k,
                    float* __restrict__ od, int* __restrict__ oi) {
  extern __shared__ __align__(16) float smem[];
  const int d4 = (d + 3) & ~3;
  float* qs = smem;
  float* qsq = qs + kSlotChunk * d4;
  float* candT = qsq + kSlotChunk;
  int* cid = reinterpret_cast<int*>(candT + d4 * (kTileC + 1));
  float* dt = reinterpret_cast<float*>(cid + kTileC);
  float* Ld = dt + kSlotChunk * kTileC;
  int* Lc = reinterpret_cast<int*>(Ld + kSlotChunk * k);
  int* Llen = Lc + kSlotChunk * k;
  int* occ = Llen + kSlotChunk;
  int* occ_row = occ + S;
  int* n_occ_s = occ_row + S;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int empty_row = n_rows - 1;
  const int* qb = qbuf + (size_t)b * S;
  const T* cb = cands + (size_t)b * C * d;
  const int* ib = ids + (size_t)b * C;
  float* odb = od + (size_t)b * S * k;
  int* oib = oi + (size_t)b * S * k;

  // occupied slots, in slot order; empty slots flush as inf / -1
  if (tid == 0) {
    int n = 0;
    for (int s = 0; s < S; ++s) {
      int r = qb[s];
      if (r >= 0 && r < empty_row) { occ[n] = s; occ_row[n] = r; ++n; }
    }
    *n_occ_s = n;
  }
  for (int e = tid; e < S * k; e += kThreads) {
    int r = qb[e / k];
    if (!(r >= 0 && r < empty_row)) { odb[e] = CUDART_INF_F; oib[e] = -1; }
  }
  __syncthreads();
  const int n_occ = *n_occ_s;

  for (int s0 = 0; s0 < n_occ; s0 += kSlotChunk) {
    const int nq = min(kSlotChunk, n_occ - s0);
    // gather this chunk's query rows, zero-padded to d4 columns and 32 rows
    for (int e = tid; e < kSlotChunk * d4; e += kThreads) {
      int s = e / d4, j = e - s * d4;
      float v = 0.f;
      if (s < nq && j < d) v = to_f32(q_pad[(size_t)occ_row[s0 + s] * d + j]);
      qs[e] = v;
    }
    if (tid < kSlotChunk) Llen[tid] = 0;
    __syncthreads();
    if (tid < kSlotChunk) {
      float acc = 0.f;
      for (int j = 0; j < d4; ++j) { float v = qs[tid * d4 + j]; acc = fmaf(v, v, acc); }
      qsq[tid] = acc;
    }
    __syncthreads();

    for (int c0 = 0; c0 < C; c0 += kTileC) {
      int any = 0;
      if (tid < kTileC) {
        int c = c0 + tid;
        int id = c < C ? ib[c] : -1;
        cid[tid] = id;
        any = id >= 0;
      }
      if (!__syncthreads_or(any)) continue;  // no valid candidate in this tile

      for (int e = tid; e < kTileC * d4; e += kThreads) {
        int r = e / d4, j = e - r * d4;
        int c = c0 + r;
        float v = 0.f;
        if (c < C && j < d) v = to_f32(cb[(size_t)c * d + j]);
        candT[j * (kTileC + 1) + r] = v;
      }
      __syncthreads();

      {  // distance tile: one candidate x kSlotsPerThread slots per thread
        const int c = tid % kTileC;
        const int s_lo = (tid / kTileC) * kSlotsPerThread;
        float acc[kSlotsPerThread];
#pragma unroll
        for (int i = 0; i < kSlotsPerThread; ++i) acc[i] = 0.f;
        float cs = 0.f;
        for (int j = 0; j < d4; j += 4) {
          const float v0 = candT[(j + 0) * (kTileC + 1) + c];
          const float v1 = candT[(j + 1) * (kTileC + 1) + c];
          const float v2 = candT[(j + 2) * (kTileC + 1) + c];
          const float v3 = candT[(j + 3) * (kTileC + 1) + c];
          cs = fmaf(v0, v0, cs); cs = fmaf(v1, v1, cs);
          cs = fmaf(v2, v2, cs); cs = fmaf(v3, v3, cs);
#pragma unroll
          for (int i = 0; i < kSlotsPerThread; ++i) {
            const float4 qv = *reinterpret_cast<const float4*>(&qs[(s_lo + i) * d4 + j]);
            acc[i] = fmaf(qv.x, v0, acc[i]);
            acc[i] = fmaf(qv.y, v1, acc[i]);
            acc[i] = fmaf(qv.z, v2, acc[i]);
            acc[i] = fmaf(qv.w, v3, acc[i]);
          }
        }
#pragma unroll
        for (int i = 0; i < kSlotsPerThread; ++i)
          dt[(s_lo + i) * kTileC + c] = qsq[s_lo + i] - 2.0f * acc[i] + cs;
      }
      __syncthreads();

      // merge: warp w owns slots w, w + 8, ...; candidates that beat the k-th
      // key are inserted in candidate order
      for (int s = warp; s < nq; s += kWarps) {
        float* Lds = Ld + s * k;
        int* Lcs = Lc + s * k;
        int len = Llen[s];
        float td = CUDART_INF_F;
        int tc = 0;
        if (len == k) { td = Lds[k - 1]; tc = Lcs[k - 1]; }
        for (int h = 0; h < kTileC; h += 32) {
          const int cl = h + lane;
          const int c = c0 + cl;
          list_offer(Lds, Lcs, len, k, td, tc, cid[cl] >= 0, dt[s * kTileC + cl], c, lane);
        }
        if (lane == 0) Llen[s] = len;
      }
      __syncthreads();
    }

    // flush the chunk's slots; unfilled places are inf / -1
    for (int s = warp; s < nq; s += kWarps) {
      const size_t o = (size_t)occ[s0 + s] * k;
      const int len = Llen[s];
      for (int i = lane; i < k; i += 32) {
        if (i < len) {
          odb[o + i] = Ld[s * k + i];
          oib[o + i] = ib[Lc[s * k + i]];
        } else {
          odb[o + i] = CUDART_INF_F;
          oib[o + i] = -1;
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch(const void* q_pad, int n_rows, const void* qbuf, int B, int S,
           const void* cands, const void* ids, int C, int d, int k,
           void* od, void* oi, void* stream) {
  const size_t smem = smem_floats(S, d, k) * sizeof(float);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(l2_topk_qbuf_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  l2_topk_qbuf_kernel<T><<<B, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)q_pad, n_rows, (const int*)qbuf, S, (const T*)cands,
      (const int*)ids, C, d, k, (float*)od, (int*)oi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes; above 232448 the launch is refused.
long long l2_topk_qbuf_smem_bytes(int S, int d, int k) {
  return (long long)(smem_floats(S, d, k) * sizeof(float));
}

// q_pad [n_rows, d], qbuf [B, S] int32, cands [B, C, d], ids [B, C] int32
// -> od [B, S, k] f32, oi [B, S, k] int32. Returns a cudaError_t.
int l2_topk_qbuf_f32(const void* q_pad, int n_rows, const void* qbuf, int B, int S,
                     const void* cands, const void* ids, int C, int d, int k,
                     void* od, void* oi, void* stream) {
  return launch<float>(q_pad, n_rows, qbuf, B, S, cands, ids, C, d, k, od, oi, stream);
}

int l2_topk_qbuf_bf16(const void* q_pad, int n_rows, const void* qbuf, int B, int S,
                      const void* cands, const void* ids, int C, int d, int k,
                      void* od, void* oi, void* stream) {
  return launch<__nv_bfloat16>(q_pad, n_rows, qbuf, B, S, cands, ids, C, d, k, od, oi,
                               stream);
}

}  // extern "C"
