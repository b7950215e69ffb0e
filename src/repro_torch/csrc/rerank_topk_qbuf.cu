// The quantized tiers' exact rerank over the ADC shortlist, for sm_90a: stage
// 2 of serving/scan.py's quantized scan. No TPU kernel is its twin (the JAX
// package reranks with plain jnp ops, repro/serving/scan.py); it replaces the
// port's own chunked gather (the plain version, kernels/ref.py:
// rerank_topk_qbuf_ref), which passed each candidate row through device
// memory about five times.
//
// For each bucket b (one local partition) and each dispatch slot s whose
// qbuf[b, s] names a query row r, with stage 1's shortlist sl[b, s, :rk] of
// slot indices:
//
//   d[p] = ||q||^2 - 2 q.x + ||x||^2,   q = q_pad[r], x = vecs[b, sl[b, s, p]]
//
// the expanded form of the plain version, products and sums in f32 (a
// bfloat16 plane is upcast exactly, as .float() does); no TF32 and no
// lower-precision product. An entry of -1, or a slot whose id is < 0, scores
// +inf. The k smallest (d, p) come out ascending as (dist, ids[b, sl[p]]),
// the id of a +inf entry as the plain version gives it (-1 for a masked
// one); inf / -1 past rk. Keys pack (dist, shortlist position)
// (topk_select.cuh), so the lower position wins an exact tie, as the plain
// version's stable sort. qbuf == n_rows - 1 is the empty slot: its warp
// writes inf / -1 and leaves, reading nothing else.
//
// What bounds it on an H100: bytes. Each (occupied slot, shortlisted row)
// pair reads d values, but the rows of one partition are shared by its ~70
// occupied slots: the distinct rows a batch touches are at most its live
// rows, read once, plus each slot's shortlist, query and list (0.295 ms at a
// lira-ann-q batch). The kernel itself reads each pair's row, ~14.5 GB a
// batch, which L2 serves at ~6 TB/s (2.7 ms, PERF.md §6). The design:
//  * one warp takes one (bucket, slot) pair end to end: its query row in
//    registers, ||q||^2 summed once, its list and staging buffer in shared
//    memory, so the scan needs no block barrier;
//  * a team of 8 lanes takes one shortlisted row, 4 rows a warp at once,
//    each lane reading its share of the row as 16-byte vectors straight from
//    the plane (a row of 128 f32 is 4 vectors a lane), so a warp's load
//    touches 4 whole 128-byte lines; q.x and ||x||^2 are summed in the lane
//    and across the team by shuffles, and the 32 distances of a round of 32
//    positions go to the lanes that offer them to the bulk selection
//    (topk_select.cuh). Rows whose width is no multiple of 16 bytes, or
//    wider than 4 vectors a lane, are read element by element (J = 0);
//  * blocks are ordered bucket-major (the slowest grid index is the bucket),
//    so the blocks of one partition's occupied slots run together and its
//    rows (~1 MB at lira-ann-q's mean) are re-read from L2, not HBM.
// Its sums are taken in a fixed order, so two runs give equal bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "scan_common.cuh"
#include "topk_select.cuh"

namespace {

using topksel::kAllLanes;
using topksel::Selector;

constexpr int kMaxWarps = 8;          // pairs a block at most
constexpr int kTeam = 8;              // lanes that share one row
constexpr int kRows = 32 / kTeam;     // rows a warp takes at once
constexpr int kRounds = 32 / kRows;   // steps of a round of 32 positions
// blocks an SM holds: at most 80 registers a thread. On an H100 at
// lira-ann-q's batch the occupancy this buys beat the spills it costs (a few
// words a thread): 2.72 ms against 3.04 at the compiler's 128 registers.
constexpr int kMinBlocks = 3;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// A 16-byte vector of the plane's type as E floats (bf16 upcast exactly).
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int E = 4;
  __device__ static __forceinline__ void unpack(const uint4& v, float (&x)[E]) {
    x[0] = __uint_as_float(v.x);
    x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z);
    x[3] = __uint_as_float(v.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static __forceinline__ void unpack(const uint4& v, float (&x)[E]) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float team_sum(float v) {
#pragma unroll
  for (int o = kTeam / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kAllLanes, v, o);
  return v;
}

// The distances of a round of up to 32 rows: lane l names its row's slot
// (valid where bit l of `live` is set) and gets its distance back. Team t
// takes rows t, t + kRows, ...; the sums run over the lane's share of the
// row, then across the team.
template <typename T, int J>
__device__ __forceinline__ float round_dists(const float (&qv)[J > 0 ? J : 1][Vec<T>::E],
                                             float qq, const float* __restrict__ q,
                                             const T* __restrict__ xb, int d, int slot,
                                             unsigned live, int lane) {
  constexpr int E = Vec<T>::E;
  const int V = d / E;  // vectors a row (J > 0)
  const int tl = lane % kTeam, team = lane / kTeam;
  float mine = CUDART_INF_F;
#pragma unroll 2
  for (int it = 0; it < kRounds; ++it) {
    if (!((live >> (it * kRows)) & ((1u << kRows) - 1))) continue;
    const int row = it * kRows + team;  // this team's position in the round
    const int rs = __shfl_sync(kAllLanes, slot, row);
    float dot = 0.f, xx = 0.f;
    if ((live >> row) & 1u) {
      const T* __restrict__ x = xb + (size_t)rs * d;
      if (J > 0) {
        uint4 u[J > 0 ? J : 1];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int v = tl + kTeam * j;
          if (v < V) u[j] = __ldg(reinterpret_cast<const uint4*>(x) + v);
        }
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (tl + kTeam * j >= V) continue;
          float xe[E];
          Vec<T>::unpack(u[j], xe);
#pragma unroll
          for (int t = 0; t < E; ++t) {
            dot = fmaf(qv[j][t], xe[t], dot);
            xx = fmaf(xe[t], xe[t], xx);
          }
        }
      } else {
        for (int e = tl; e < d; e += kTeam) {
          const float xe = to_f32(x[e]);
          dot = fmaf(__ldg(q + e), xe, dot);
          xx = fmaf(xe, xe, xx);
        }
      }
    }
    dot = team_sum(dot);
    xx = team_sum(xx);
    const float dist = qq - 2.f * dot + xx;
    // position l of the round was computed by team l % kRows at step l / kRows
    const float got = __shfl_sync(kAllLanes, dist, (lane % kRows) * kTeam);
    if (lane / kRows == it) mine = got;
  }
  return mine;
}

// One (bucket, slot) pair end to end, by one warp: the slot's list in
// d_out / i_out [k]. J > 0: each lane of a team reads vectors tl + 8 j,
// j < J, of a row (rows of a whole number of 16-byte vectors, 16-byte
// aligned); J = 0: element by element.
template <typename T, int J>
__device__ __forceinline__ void rerank_slot(unsigned char* mine, const float* __restrict__ q_pad,
                                            int n_rows, int r, const T* __restrict__ xb,
                                            const int* __restrict__ ib, int C, int d,
                                            const int* __restrict__ slr, int rk, int k,
                                            float* __restrict__ d_out, int* __restrict__ i_out,
                                            int lane) {
  if (r < 0 || r >= n_rows - 1) {  // the empty slot
    scancommon::fill_empty(d_out, i_out, k, lane);
    return;
  }
  constexpr int E = Vec<T>::E;
  const int V = d / E;  // vectors a row (J > 0)
  const int tl = lane % kTeam;
  const float* __restrict__ q = q_pad + (size_t)r * d;
  float qv[J > 0 ? J : 1][E];
  float qq = 0.f;
  if (J > 0) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int v = tl + kTeam * j;
#pragma unroll
      for (int t = 0; t < E; ++t) {
        qv[j][t] = v < V ? __ldg(q + v * E + t) : 0.f;
        qq = fmaf(qv[j][t], qv[j][t], qq);
      }
    }
  } else {
    for (int e = tl; e < d; e += kTeam) {
      const float x = __ldg(q + e);
      qq = fmaf(x, x, qq);
    }
  }
  qq = team_sum(qq);

  Selector sel;
  sel.init(mine, k);
  __syncwarp();
  for (int p0 = 0; p0 < rk; p0 += 32) {
    const int p = p0 + lane;
    const int slot = p < rk ? __ldg(slr + p) : -1;
    const bool live = slot >= 0 && slot < C && __ldg(ib + slot) >= 0;
    const float dist = round_dists<T, J>(qv, qq, q, xb, d, slot, __ballot_sync(kAllLanes, live),
                                         lane);
    sel.offer(p < rk, topksel::pack(live ? dist : CUDART_INF_F, p), lane);
  }
  sel.flush(lane);
  for (int i = lane; i < k; i += 32) {
    float dist = CUDART_INF_F;
    int id = -1;
    if (i < sel.len) {
      const uint64_t key = sel.list[i];
      dist = topksel::key_dist(key);
      const int slot = __ldg(slr + topksel::key_pos(key));
      id = slot >= 0 && slot < C ? __ldg(ib + slot) : -1;
    }
    d_out[i] = dist;
    i_out[i] = id;
  }
}

// A block takes G consecutive slots of one bucket, a warp each.
template <typename T, int J>
__global__ void __launch_bounds__(32 * kMaxWarps, kMinBlocks)
rerank_topk_qbuf_kernel(const float* __restrict__ q_pad, int n_rows,
                        const int* __restrict__ qbuf, int S, const T* __restrict__ vecs,
                        const int* __restrict__ ids, int C, int d,
                        const int* __restrict__ shortlist, int rk, int k,
                        float* __restrict__ od, int* __restrict__ oi) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = blockDim.x / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (S + G - 1) / G;
  const int b = blockIdx.x / groups;                  // bucket-major
  const int s = (blockIdx.x - b * groups) * G + warp;
  if (s >= S) return;
  const size_t pair = (size_t)b * S + s;
  rerank_slot<T, J>(smem + (size_t)warp * topksel::row_bytes(k), q_pad, n_rows,
                    __ldg(qbuf + pair), vecs + (size_t)b * C * d, ids + (size_t)b * C, C, d,
                    shortlist + pair * rk, rk, k, od + pair * k, oi + pair * k, lane);
}

// Pairs (warps) a block: as many as kMaxWarps whose lists and buffers fit a
// block's shared memory; 0 when not even one does.
int warps_for(int k) {
  const size_t per = topksel::row_bytes(k);
  const size_t fit = scancommon::kMaxSmem / per;
  return (int)(fit < (size_t)kMaxWarps ? fit : (size_t)kMaxWarps);
}

// Vectors a lane reads of a row: kVectors (those past the row's end masked)
// when a row is a whole number of 16-byte vectors on a 16-byte boundary, at
// most kTeam · kVectors of them (d <= 128 in f32, 256 in bf16); else 0,
// element by element.
constexpr int kVectors = 4;

int lane_vectors(const void* vecs, int d, int itemsize) {
  if ((d * itemsize) % 16 || (reinterpret_cast<uintptr_t>(vecs) & 15)) return 0;
  return d * itemsize / 16 <= kTeam * kVectors ? kVectors : 0;
}

template <typename T, int J>
int run(int G, const float* q_pad, int n_rows, const int* qbuf, int B, int S, const T* vecs,
        const int* ids, int C, int d, const int* shortlist, int rk, int k, float* od, int* oi,
        cudaStream_t stream) {
  const size_t smem = (size_t)G * topksel::row_bytes(k);
  auto kernel = rerank_topk_qbuf_kernel<T, J>;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
      cudaSuccess)
    return (int)cudaGetLastError();
  const long long blocks = (long long)B * ((S + G - 1) / G);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, 32 * G, smem, stream>>>(q_pad, n_rows, qbuf, S, vecs, ids, C, d,
                                                     shortlist, rk, k, od, oi);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q_pad, int n_rows, const void* qbuf, int B, int S, const void* vecs,
           const void* ids, int C, int d, const void* shortlist, int rk, int k, void* od,
           void* oi, void* stream) {
  const int G = warps_for(k);
  if (G == 0 || k < 1 || d < 1 || rk < 0 || n_rows < 1) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  auto fn = lane_vectors(vecs, d, sizeof(T)) ? run<T, kVectors> : run<T, 0>;
  return fn(G, (const float*)q_pad, n_rows, (const int*)qbuf, B, S, (const T*)vecs,
            (const int*)ids, C, d, (const int*)shortlist, rk, k, (float*)od, (int*)oi,
            (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// q_pad [n_rows, d] f32 (row n_rows - 1 the empty slot's), qbuf [B, S] int32,
// vecs [B, C, d] f32 or bf16, ids [B, C] int32, shortlist [B, S, rk] int32
// slot indices (-1 = none) -> od [B, S, k] f32, oi [B, S, k] int32. Returns a
// cudaError_t.
int rerank_topk_qbuf_f32(const void* q_pad, int n_rows, const void* qbuf, int B, int S,
                         const void* vecs, const void* ids, int C, int d, const void* shortlist,
                         int rk, int k, void* od, void* oi, void* stream) {
  return launch<float>(q_pad, n_rows, qbuf, B, S, vecs, ids, C, d, shortlist, rk, k, od, oi,
                       stream);
}

int rerank_topk_qbuf_bf16(const void* q_pad, int n_rows, const void* qbuf, int B, int S,
                          const void* vecs, const void* ids, int C, int d, const void* shortlist,
                          int rk, int k, void* od, void* oi, void* stream) {
  return launch<__nv_bfloat16>(q_pad, n_rows, qbuf, B, S, vecs, ids, C, d, shortlist, rk, k,
                               od, oi, stream);
}

}  // extern "C"
