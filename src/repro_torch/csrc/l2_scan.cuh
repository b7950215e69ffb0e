// The block-level body of the L2 scans (l2_topk_qbuf.cu, l2_topk.cu): a group
// of up to G query rows is scanned against a range of one candidate set, each
// row keeping its k smallest with a bulk selection (topk_select.cuh).
//
// For row i of the group, rows[i] (or row0 + i) names its query row and
// outs[i] (or out0 + i) its output row. Each candidate's distance is
//
//   ||q||^2 - 2 q.c + ||c||^2
//
// with q.c, ||c||^2 and ||q||^2 each an fmaf chain over the columns in
// ascending order, f32 accumulation (bf16 is upcast with __bfloat162float),
// and that expression last: the order of every earlier version of these
// kernels, so their distances are equal bit for bit. Candidates with id < 0
// are masked; keys are (dist, position in the set), so an earlier candidate
// wins an exact tie, as on the TPU, and a NaN sorts by its sign, as the plain
// version on the card; a valid candidate whose distance is not finite gets
// id -1, as in the plain version (topk_select.cuh).
//
// What bounds the scans is operations: 2*d flops per (row, valid candidate)
// at the CUDA-core f32 rate. The design (PERF.md §6 has the measurements):
//  * a block takes G rows (16 or 32) of one set: G / 16 row slices by 8
//    candidate slices, one warp each. The query rows sit in shared memory for
//    the whole range; the candidates stream through it in tiles of 256,
//    kDepth columns (16 or 32) at a time, in two buffers: the next chunk is
//    copied asynchronously (cp.async, 16 bytes a lane, where f32 rows allow)
//    while the block computes the current one, so a chunk costs one barrier
//    and no exposed load. The caller ends a range at its last valid id, a
//    tile with no valid id is skipped whole, and the next tile's ids are
//    read while this one is computed;
//  * the distances are register-tiled: a warp computes a slice of 16 rows x
//    32 candidates, a lane 4 rows x 4 candidates from 16-byte shared loads
//    (64 FMAs per 8 loads). A slice computes only the row quads that hold one
//    of the group's rows, and a slice of candidates past the range's end
//    computes nothing. ||c||^2 is taken once a candidate, its fmaf chain
//    interleaved with the products;
//  * the distances go through a shared tile to the warp that owns each row
//    (warp w selects for rows w, w + W, ...). A float compare against the
//    k-th key's distance passes over most candidates; the rest are filtered
//    against the k-th key and sorted and merged 256 at a time;
//  * G and blocks an SM come from the occupancy calculator for the kernel
//    that is launched (`plan`): the G with the most rows resident on an SM.
//    A row needs its list and buffer (~2.9 KB at k = 100), its query row and
//    its share of the distance tile; the two candidate chunks come on top.
//    On a tie the dispatch-buffer scan takes the smaller G (a hot bucket
//    spreads over more blocks), the flat and batched scans the larger (each
//    staged candidate serves twice the rows: at 16 rows the copies outrun
//    what the card's L2 delivers to an SM).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"
#include "topk_select.cuh"

namespace l2scan {

using scancommon::align16;
using scancommon::fill_empty;
using scancommon::kMaxSmem;
using scancommon::Plan;
using topksel::kAllLanes;
using topksel::Selector;

constexpr int kSliceRows = 16;           // a warp's slice: 4 lane rows x 4 registers
constexpr int kSliceCands = 32;          //   by 8 lane columns x 4 registers
constexpr int kRangeUnit = 256;          // a split range is a whole number of these

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__host__ __device__ inline int pad4(int d) { return (d + 3) & ~3; }
// a query row's stride in shared memory, in floats
__host__ __device__ inline int query_ld(int d) { return pad4(d) + 4; }

// The block of a group of G rows: G / 16 row slices by 8 candidate slices,
// one warp each, so a tile is 256 candidates whatever G.
template <int G>
struct Shape {
  static_assert(G == 16 || G == 32, "G: 16 or 32");
  static constexpr int kRowSlices = G / kSliceRows;
  static constexpr int kCandSlices = 8;
  static constexpr int kWarps = kRowSlices * kCandSlices;   // 8 or 16
  static constexpr int kThreads = 32 * kWarps;
  // columns of a candidate tile staged at once (at G = 16, two blocks fit an
  // SM only with 16), and a staged row's stride in floats
  static constexpr int kDepth = G == 32 ? 32 : 16;
  static constexpr int kTileLd = kDepth + 4;
  static constexpr int kTileC = kSliceCands * kCandSlices;  // candidates a tile
  static constexpr int kDistLd = kTileC + 8;                // distance tile's stride
  static constexpr int kRowsPerWarp = G / kWarps;           // rows a warp selects for
  static_assert(kThreads >= kTileC, "a thread a candidate of a tile");
  static_assert(kRangeUnit % kTileC == 0, "a range unit is whole tiles");
};

// Byte offsets of a block's shared memory.
template <int G>
struct Layout {
  size_t outs, rows, qs, qsq, tile, tile_floats, cn, cid, dt, sel, total;
  __host__ __device__ Layout(int d, int k) {
    using S = Shape<G>;
    size_t o = 16;  // the range end (or the dispatch-buffer scan's work item)
    outs = o;  o += align16(G * 4);
    rows = o;  o += align16(G * 4);
    qs = o;    o += align16((size_t)G * query_ld(d) * 4);
    qsq = o;   o += align16(G * 4);
    tile_floats = align16((size_t)S::kTileC * S::kTileLd * 4) / 4;
    tile = o;  o += 2 * tile_floats * 4;  // two chunks, alternately
    cn = o;    o += align16(S::kTileC * 4);
    cid = o;   o += align16(2 * S::kTileC * 4);  // two tiles' ids, alternately
    dt = o;    o += align16((size_t)G * S::kDistLd * 4);
    sel = o;   o += (size_t)G * topksel::row_bytes(k);
    total = o;
  }
};

template <int G>
inline size_t smem_bytes(int d, int k) { return Layout<G>(d, k).total; }

// The group size with the most rows resident on an SM, from the occupancy
// calculator for the two instantiations of the kernel that is launched; on a
// tie the larger G when `larger` is set, else the smaller. A nonzero `only`
// (16 or 32) considers that G alone: its plan, or G = 0 when it does not fit.
template <typename K16, typename K32>
inline Plan plan(K16* k16, K32* k32, int d, int k, bool larger, int only = 0) {
  Plan best;
  auto consider = [&](auto* kernel, int G, size_t smem) {
    int per_sm = 0;
    if (smem > kMaxSmem ||
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 16 * G, smem) !=
            cudaSuccess ||
        per_sm == 0)
      return;
    const long long rows = (long long)G * per_sm, had = (long long)best.G * best.per_sm;
    if (rows > had || (rows == had && larger)) best = {G, smem, per_sm};
  };
  if (only == 0 || only == 16) consider(k16, 16, smem_bytes<16>(d, k));
  if (only == 0 || only == 32) consider(k32, 32, smem_bytes<32>(d, k));
  return best;
}

// Copy 16 bytes from device to shared memory without a register, or write
// zeros when `ok` is false (the source is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage columns [j0, j0 + kDepth) of the TC candidates from c0 into `buf`,
// zero past c_end and past d, a warp a few rows at a time and no division
// by the runtime width. f32 rows are copied asynchronously, 16 bytes a lane
// (cp_async_wait_all waits for them), when `vec` (d a multiple of 4, rows
// 16-byte aligned); other rows go through registers (bf16 upcast with
// __bfloat162float), one lane a column and all of a lane's rows in flight.
template <typename S, int BYTES>
struct Lanes {  // a lane's place when each copies BYTES of a row
  static constexpr int kPerRow = S::kDepth * 4 / BYTES;  // lanes a row
  static constexpr int kRowsAtOnce = 32 / kPerRow;       // rows a warp instruction
  static constexpr int kRows = S::kTileC / (kRowsAtOnce * S::kWarps);  // rows a lane
  static __device__ __forceinline__ int col(int lane) { return (lane % kPerRow) * BYTES / 4; }
  static __device__ __forceinline__ int row(int lane, int warp, int i) {
    return kRowsAtOnce * (warp + S::kWarps * i) + lane / kPerRow;
  }
};

template <typename S, typename T>
__device__ __forceinline__ void stage_chunk(float* buf, const T* __restrict__ cb, int c0,
                                            int c_end, int j0, int d, bool vec) {
  constexpr int LD = S::kTileLd;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if constexpr (sizeof(T) == 4) {
    if (vec) {
      const float* src = reinterpret_cast<const float*>(cb);
      using L = Lanes<S, 16>;
      const int col = L::col(lane), j = j0 + col;
#pragma unroll
      for (int i = 0; i < L::kRows; ++i) {
        const int r = L::row(lane, warp, i), c = c0 + r;
        const bool ok = c < c_end && j < d;
        cp_async16(buf + r * LD + col, ok ? src + (size_t)c * d + j : src, ok);
      }
      cp_async_commit();
      return;
    }
  }
  using L = Lanes<S, 4>;
  const int col = L::col(lane), j = j0 + col;
  float v[L::kRows];
#pragma unroll
  for (int i = 0; i < L::kRows; ++i) {
    const int c = c0 + L::row(lane, warp, i);
    v[i] = c < c_end && j < d ? to_f32(cb[(size_t)c * d + j]) : 0.f;
  }
#pragma unroll
  for (int i = 0; i < L::kRows; ++i) buf[L::row(lane, warp, i) * LD + col] = v[i];
}

// The first tile at or after c0 with a valid id (c_end when none), its ids in
// cid [TC]; every thread of the block calls this (a barrier a tile looked at).
template <int TC>
__device__ __forceinline__ int seek_tile(int* cid, const int* __restrict__ ib, int c0,
                                         int c_end) {
  for (; c0 < c_end; c0 += TC) {
    int any = 0;
    for (int t = threadIdx.x; t < TC; t += blockDim.x) {
      const int c = c0 + t;
      const int id = c < c_end ? __ldg(ib + c) : -1;
      cid[t] = id;
      any |= id >= 0;
    }
    if (__syncthreads_or(any)) return c0;
  }
  return c_end;
}

// One staged chunk of `steps` x 4 columns, in column order: acc[i][u] += q.c
// for the lane's rows row_lo + 4i (i < RI; none when RI is 0) and candidates
// c_lo + 8u, and cnorm += ||c||^2 of the staged row nrow, its chain
// interleaved with the products so that its latency hides behind them.
template <int RI, int DEPTH>
__device__ __forceinline__ void chunk_fma(const float* __restrict__ qrow, int ldq,
                                          const float* __restrict__ crow,
                                          const float* __restrict__ nrow, int steps,
                                          float (&acc)[4][4], float& cnorm) {
#pragma unroll
  for (int s = 0; s < DEPTH / 4; ++s) {
    if (s >= steps) break;
    const float4 v = *reinterpret_cast<const float4*>(nrow + 4 * s);
    cnorm = fmaf(v.x, v.x, cnorm);
    cnorm = fmaf(v.y, v.y, cnorm);
    cnorm = fmaf(v.z, v.z, cnorm);
    cnorm = fmaf(v.w, v.w, cnorm);
    float4 q[RI > 0 ? RI : 1], c[4];
#pragma unroll
    for (int i = 0; i < RI; ++i)
      q[i] = *reinterpret_cast<const float4*>(qrow + (size_t)4 * i * ldq + 4 * s);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (RI > 0) c[u] = *reinterpret_cast<const float4*>(crow + 8 * u * (DEPTH + 4) + 4 * s);
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        acc[i][u] = fmaf(q[i].x, c[u].x, acc[i][u]);
        acc[i][u] = fmaf(q[i].y, c[u].y, acc[i][u]);
        acc[i][u] = fmaf(q[i].z, c[u].z, acc[i][u]);
        acc[i][u] = fmaf(q[i].w, c[u].w, acc[i][u]);
      }
  }
}

// Scan candidates [c_lo, c_end) of one set (rows cb [*, d], ids ib) for the
// group's nq rows (1 <= nq <= G) of q [*, d] and write row i's list to
// od / oi [outs[i] * k, + k) (or out0 + i): the id ib[position] (-1 beside a
// distance that is not finite), or the position itself, whatever the
// distance, when write_ids is false (the merge applies that rule); inf / -1
// past a list's length. rows / outs, when given, are the layout's arrays,
// written before the call. Every thread of the block calls this.
template <int G, typename T>
__device__ void scan_group(unsigned char* smem, const T* __restrict__ q, bool rows_given,
                           size_t row0, int nq, int d, const T* __restrict__ cb,
                           const int* __restrict__ ib, int c_lo, int c_end, int k,
                           float* __restrict__ od, int* __restrict__ oi, bool outs_given,
                           size_t out0, bool write_ids) {
  using S = Shape<G>;
  constexpr int TC = S::kTileC, kWarps = S::kWarps, kDepth = S::kDepth, kTileLd = S::kTileLd;
  const Layout<G> lay(d, k);
  const int* outs = reinterpret_cast<const int*>(smem + lay.outs);
  const int* rows = reinterpret_cast<const int*>(smem + lay.rows);
  float* qs = reinterpret_cast<float*>(smem + lay.qs);
  float* qsq = reinterpret_cast<float*>(smem + lay.qsq);
  float* tile = reinterpret_cast<float*>(smem + lay.tile);
  float* cn = reinterpret_cast<float*>(smem + lay.cn);
  int* cid2 = reinterpret_cast<int*>(smem + lay.cid);
  float* dt = reinterpret_cast<float*>(smem + lay.dt);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d4 = pad4(d), ldq = query_ld(d);
  __syncthreads();  // rows / outs written by the caller

  // the group's query rows, zero past nq and past d; warp w stages rows
  // w, w + W, ..., lane l columns l, l + 32, ...
  for (int j = lane; j < d4; j += 32) {
    float v[S::kRowsPerWarp];
#pragma unroll
    for (int m = 0; m < S::kRowsPerWarp; ++m) {
      const int i = warp + m * kWarps;
      v[m] = 0.f;
      if (i < nq && j < d) v[m] = to_f32(q[(rows_given ? (size_t)rows[i] : row0 + i) * d + j]);
    }
#pragma unroll
    for (int m = 0; m < S::kRowsPerWarp; ++m) qs[(warp + m * kWarps) * ldq + j] = v[m];
  }
  __syncthreads();
  if (tid < G) {  // ||q||^2, in column order
    float acc = 0.f;
    for (int j = 0; j < d4; ++j) { const float v = qs[tid * ldq + j]; acc = fmaf(v, v, acc); }
    qsq[tid] = acc;
  }

  Selector sel[S::kRowsPerWarp];
#pragma unroll
  for (int m = 0; m < S::kRowsPerWarp; ++m)
    sel[m].init(smem + lay.sel + (size_t)(warp + m * kWarps) * topksel::row_bytes(k), k);

  // this warp's slice of the distance tile and this lane's place in it
  const int rs = warp / S::kCandSlices, cs = warp % S::kCandSlices;
  const int ty = lane >> 3, tx = lane & 7;
  const int row_lo = rs * kSliceRows + ty;    // rows row_lo + 4i
  const int cand_lo = cs * kSliceCands + tx;  // candidates cand_lo + 8u
  const int quads = min(4, max(0, (nq - rs * kSliceRows + 3) / 4));  // row quads with a row

  // the tiles with a valid id, each chunk of columns staged while the one
  // before it is computed; tiles' ids alternate between two buffers
  float* bufs[2] = {tile, tile + lay.tile_floats};
  int p = 0, nb = 0;
  int c0 = seek_tile<TC>(cid2, ib, c_lo, c_end);
  const bool vec = sizeof(T) == 4 && (d & 3) == 0 && (reinterpret_cast<uintptr_t>(cb) & 15) == 0;
  if (c0 < c_end) stage_chunk<S>(bufs[0], cb, c0, c_end, 0, d, vec);
  while (c0 < c_end) {
    const int* cid = cid2 + p * TC;
    const bool live = quads > 0 && c0 + cs * kSliceCands < c_end;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
    float cnorm = 0.f;  // ||c||^2 of candidate c0 + tid % TC
    int c_next = c_end;
    // the next tile's ids, read while this tile is computed
    const int id_next = tid < TC && c0 + TC + tid < c_end ? __ldg(ib + c0 + TC + tid) : -1;
    for (int j0 = 0; j0 < d4; j0 += kDepth, nb ^= 1) {
      cp_async_wait_all();
      __syncthreads();  // chunk j0 is in bufs[nb]; every warp is done with bufs[nb ^ 1]
      if (j0 + kDepth < d4) {
        stage_chunk<S>(bufs[nb ^ 1], cb, c0, c_end, j0 + kDepth, d, vec);
      } else {  // the next tile with a valid id, and its first chunk
        int* cid_next = cid2 + (p ^ 1) * TC;
        if (tid < TC) cid_next[tid] = id_next;
        c_next = c0 + TC >= c_end                ? c_end
                 : __syncthreads_or(id_next >= 0) ? c0 + TC
                                                  : seek_tile<TC>(cid_next, ib, c0 + 2 * TC, c_end);
        if (c_next < c_end) stage_chunk<S>(bufs[nb ^ 1], cb, c_next, c_end, 0, d, vec);
      }
      const float* buf = bufs[nb];
      const int steps = min(kDepth, d4 - j0) / 4;
      // this thread's norm: candidate tid % TC (written by the first TC)
      const float* nrow = buf + (tid % TC) * kTileLd;
      const float* qrow = qs + row_lo * ldq + j0;
      const float* crow = buf + cand_lo * kTileLd;
      switch (live ? quads : 0) {
        case 0: chunk_fma<0, kDepth>(qrow, ldq, crow, nrow, steps, acc, cnorm); break;
        case 1: chunk_fma<1, kDepth>(qrow, ldq, crow, nrow, steps, acc, cnorm); break;
        case 2: chunk_fma<2, kDepth>(qrow, ldq, crow, nrow, steps, acc, cnorm); break;
        case 3: chunk_fma<3, kDepth>(qrow, ldq, crow, nrow, steps, acc, cnorm); break;
        default: chunk_fma<4, kDepth>(qrow, ldq, crow, nrow, steps, acc, cnorm); break;
      }
      if (tid < TC && j0 + kDepth >= d4) cn[tid] = cnorm;
    }
    __syncthreads();  // every candidate's norm is in cn

    if (live) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= quads) break;
        const int r = row_lo + 4 * i;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int c = cand_lo + 8 * u;
          dt[r * S::kDistLd + c] = qsq[r] - 2.0f * acc[i][u] + cn[c];
        }
      }
    }
    __syncthreads();

    // each warp offers its rows' distances, 32 candidates at a time; a
    // distance above the k-th key's cannot enter, so a float compare passes
    // over most of them (the k-th key's distance is NaN while a list is
    // short, and a NaN distance goes on to the keyed compare)
#pragma unroll
    for (int m = 0; m < S::kRowsPerWarp; ++m) {
      const int r = warp + m * kWarps;
      if (r >= nq) break;
      const float kd = topksel::key_dist(sel[m].kth);
      for (int h = 0; h < TC; h += 32) {
        const int cl = h + lane;
        const float dist = dt[r * S::kDistLd + cl];
        const bool ok = cid[cl] >= 0;
        if (__any_sync(kAllLanes, ok && !(dist > kd)))
          sel[m].offer(ok, topksel::pack(dist, c0 + cl), lane);
      }
    }
    // the next tile's distances and norms are written only after its
    // barriers, which every warp reaches after this selection
    c0 = c_next;
    p ^= 1;
  }

#pragma unroll
  for (int m = 0; m < S::kRowsPerWarp; ++m) {
    const int r = warp + m * kWarps;
    if (r >= nq) break;
    sel[m].flush(lane);
    const size_t o = (outs_given ? (size_t)outs[r] : out0 + r) * k;
    sel[m].store(od + o, oi + o, write_ids ? ib : nullptr, lane);
  }
}

}  // namespace l2scan
