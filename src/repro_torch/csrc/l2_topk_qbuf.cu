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
// The chunk's scan is l2_scan.cuh's, shared with the flat and batched scans
// (l2_topk.cu); this file adds the gather through qbuf and the empty slots.
// wgmma/TMA and a heap-free selection are later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "l2_scan.cuh"

namespace {

using namespace l2scan;

__host__ __device__ inline size_t smem_floats(int S, int d, int k) {
  return chunk_floats(d, k)
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
  const Chunk ch = carve(smem, d, k);
  int* occ = ch.end;
  int* occ_row = occ + S;
  int* n_occ_s = occ_row + S;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
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
    begin_chunk(ch, q_pad, occ_row + s0, 0, nq, d);
    scan_range(ch, cb, ib, 0, C, d, k, nq);
    flush_chunk(ch, nq, k, odb, oib, occ + s0, 0, ib);
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
