// The block-level body of the L2 scans (l2_topk_qbuf.cu, l2_topk.cu): a chunk
// of up to 32 query rows held in shared memory is scanned against a range of
// one candidate set, each row keeping a running top-k list (topk_list.cuh).
//
// Per chunk: `begin_chunk` loads the rows (through an index list, or a
// contiguous run), their squared norms, and empties the lists; `scan_range`
// streams candidate tiles of 64, computes ||q||^2 - 2 q.c + ||c||^2 with f32
// accumulation (bf16 is upcast with __bfloat162float), masks ids < 0, skips
// tiles with no valid id, and offers each tile to the lists keyed by
// (dist, position in the set), so an earlier candidate wins an exact tie as
// on the TPU; `flush_chunk` writes each list, inf / -1 past its length.
//
// Each tile of 64 candidates is read from device memory once per chunk and
// kept transposed in shared memory; each thread computes 8 rows x 1 candidate
// with float4 broadcast reads of the query rows. One warp owns a row's list.
// Tiles and rows are staged one warp per row and one lane per column, which
// needs no division by the runtime width (a division per element was a third
// of a tile's instructions), with several rows' loads in flight per lane; a
// range ends at its last valid id, so trailing padding costs no tile.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "topk_list.cuh"

namespace l2scan {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlotChunk = 32;   // query rows scanned together
constexpr int kTileC = 64;       // candidates per shared-memory tile
constexpr int kSlotsPerThread = kSlotChunk * kTileC / kThreads;
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can opt into

static_assert(kSlotChunk * kTileC % kThreads == 0, "tile must split evenly");
static_assert(kThreads / kTileC * kSlotsPerThread == kSlotChunk, "slot groups");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__host__ __device__ inline int pad4(int d) { return (d + 3) & ~3; }

// Floats of shared memory one chunk needs.
__host__ __device__ inline size_t chunk_floats(int d, int k) {
  const size_t d4 = (size_t)pad4(d);
  return kSlotChunk * d4            // qs: query rows, f32
         + kSlotChunk               // qsq
         + d4 * (kTileC + 1)        // candT: transposed tile
         + kTileC                   // cid
         + (size_t)kSlotChunk * kTileC  // dt: distance tile
         + 2 * (size_t)kSlotChunk * k   // Ld, Lc: running lists
         + kSlotChunk;              // Llen
}

struct Chunk {
  float* qs;
  float* qsq;
  float* candT;
  int* cid;
  float* dt;
  float* Ld;
  int* Lc;
  int* Llen;
  int* end;  // first word past the chunk's working set
};

__device__ __forceinline__ Chunk carve(float* smem, int d, int k) {
  const int d4 = pad4(d);
  Chunk ch;
  ch.qs = smem;
  ch.qsq = ch.qs + kSlotChunk * d4;
  ch.candT = ch.qsq + kSlotChunk;
  ch.cid = reinterpret_cast<int*>(ch.candT + d4 * (kTileC + 1));
  ch.dt = reinterpret_cast<float*>(ch.cid + kTileC);
  ch.Ld = ch.dt + kSlotChunk * kTileC;
  ch.Lc = reinterpret_cast<int*>(ch.Ld + kSlotChunk * k);
  ch.Llen = ch.Lc + kSlotChunk * k;
  ch.end = ch.Llen + kSlotChunk;
  return ch;
}

// Stage kRows rows of d4 columns into shared memory: warp w takes rows
// w, w + 8, ... and lane l columns l, l + 32, ...; load(r, j) gives the value
// (0 past the data) and store(r, j, v) writes it.
template <int kRows, typename Load, typename Store>
__device__ __forceinline__ void stage(int d4, Load load, Store store) {
  static_assert(kRows % kWarps == 0, "rows must split over the warps");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int j = lane; j < d4; j += 32) {
    float v[kRows / kWarps];
#pragma unroll
    for (int i = 0; i < kRows / kWarps; ++i) v[i] = load(warp + i * kWarps, j);
#pragma unroll
    for (int i = 0; i < kRows / kWarps; ++i) store(warp + i * kWarps, j, v[i]);
  }
}

// Load the chunk's nq query rows of q [*, d] — row rows[s], or row0 + s when
// rows is null — zero-padded to d4 columns and 32 rows; their squared norms;
// empty lists.
template <typename T>
__device__ void begin_chunk(const Chunk& ch, const T* __restrict__ q, const int* rows,
                            size_t row0, int nq, int d) {
  const int d4 = pad4(d), tid = threadIdx.x;
  stage<kSlotChunk>(
      d4,
      [&](int s, int j) {
        if (s >= nq || j >= d) return 0.f;
        const size_t r = rows ? (size_t)rows[s] : row0 + s;
        return to_f32(q[r * d + j]);
      },
      [&](int s, int j, float v) { ch.qs[s * d4 + j] = v; });
  if (tid < kSlotChunk) ch.Llen[tid] = 0;
  __syncthreads();
  if (tid < kSlotChunk) {
    float acc = 0.f;
    for (int j = 0; j < d4; ++j) { float v = ch.qs[tid * d4 + j]; acc = fmaf(v, v, acc); }
    ch.qsq[tid] = acc;
  }
  __syncthreads();
}

// Offer candidates [c_lo, c_hi) of one set (rows cb [*, d], ids ib) to the
// chunk's nq lists, keyed by position in the set.
template <typename T>
__device__ void scan_range(const Chunk& ch, const T* __restrict__ cb,
                           const int* __restrict__ ib, int c_lo, int c_hi, int d, int k,
                           int nq) {
  const int d4 = pad4(d);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  {  // end the range at its last valid id
    __shared__ int last_s;
    if (tid == 0) last_s = c_lo - 1;
    __syncthreads();
    int last = c_lo - 1;
#pragma unroll 8
    for (int c = c_lo + tid; c < c_hi; c += kThreads)
      if (ib[c] >= 0) last = c;
    if (last >= c_lo) atomicMax(&last_s, last);
    __syncthreads();
    c_hi = last_s + 1;
  }
  for (int c0 = c_lo; c0 < c_hi; c0 += kTileC) {
    int any = 0;
    if (tid < kTileC) {
      int c = c0 + tid;
      int id = c < c_hi ? ib[c] : -1;
      ch.cid[tid] = id;
      any = id >= 0;
    }
    if (!__syncthreads_or(any)) continue;  // no valid candidate in this tile

    stage<kTileC>(
        d4,
        [&](int r, int j) {
          const int c = c0 + r;
          return c < c_hi && j < d ? to_f32(cb[(size_t)c * d + j]) : 0.f;
        },
        [&](int r, int j, float v) { ch.candT[j * (kTileC + 1) + r] = v; });
    __syncthreads();

    {  // distance tile: one candidate x kSlotsPerThread rows per thread
      const int c = tid % kTileC;
      const int s_lo = (tid / kTileC) * kSlotsPerThread;
      float acc[kSlotsPerThread];
#pragma unroll
      for (int i = 0; i < kSlotsPerThread; ++i) acc[i] = 0.f;
      float cs = 0.f;
      for (int j = 0; j < d4; j += 4) {
        const float v0 = ch.candT[(j + 0) * (kTileC + 1) + c];
        const float v1 = ch.candT[(j + 1) * (kTileC + 1) + c];
        const float v2 = ch.candT[(j + 2) * (kTileC + 1) + c];
        const float v3 = ch.candT[(j + 3) * (kTileC + 1) + c];
        cs = fmaf(v0, v0, cs); cs = fmaf(v1, v1, cs);
        cs = fmaf(v2, v2, cs); cs = fmaf(v3, v3, cs);
#pragma unroll
        for (int i = 0; i < kSlotsPerThread; ++i) {
          const float4 qv = *reinterpret_cast<const float4*>(&ch.qs[(s_lo + i) * d4 + j]);
          acc[i] = fmaf(qv.x, v0, acc[i]);
          acc[i] = fmaf(qv.y, v1, acc[i]);
          acc[i] = fmaf(qv.z, v2, acc[i]);
          acc[i] = fmaf(qv.w, v3, acc[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kSlotsPerThread; ++i)
        ch.dt[(s_lo + i) * kTileC + c] = ch.qsq[s_lo + i] - 2.0f * acc[i] + cs;
    }
    __syncthreads();

    // merge: warp w owns rows w, w + 8, ...; candidates that beat the k-th
    // key are inserted in candidate order
    for (int s = warp; s < nq; s += kWarps) {
      float* Lds = ch.Ld + s * k;
      int* Lcs = ch.Lc + s * k;
      int len = ch.Llen[s];
      float td = CUDART_INF_F;
      int tc = 0;
      if (len == k) { td = Lds[k - 1]; tc = Lcs[k - 1]; }
      for (int h = 0; h < kTileC; h += 32) {
        const int cl = h + lane;
        list_offer(Lds, Lcs, len, k, td, tc, ch.cid[cl] >= 0, ch.dt[s * kTileC + cl], c0 + cl,
                   lane);
      }
      if (lane == 0) ch.Llen[s] = len;
    }
    __syncthreads();
  }
}

// Write the chunk's nq lists to rows slots[s] (or row0 + s when slots is
// null) of od / oi [*, k]: the id ib[position], or the position itself when
// ib is null; inf / -1 past a list's length.
__device__ __forceinline__ void flush_chunk(const Chunk& ch, int nq, int k,
                                            float* __restrict__ od, int* __restrict__ oi,
                                            const int* slots, size_t row0,
                                            const int* __restrict__ ib) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int s = warp; s < nq; s += kWarps) {
    const size_t o = (slots ? (size_t)slots[s] : row0 + s) * k;
    const int len = ch.Llen[s];
    for (int i = lane; i < k; i += 32) {
      if (i < len) {
        const int c = ch.Lc[s * k + i];
        od[o + i] = ch.Ld[s * k + i];
        oi[o + i] = ib ? ib[c] : c;
      } else {
        od[o + i] = CUDART_INF_F;
        oi[o + i] = -1;
      }
    }
  }
}

}  // namespace l2scan
