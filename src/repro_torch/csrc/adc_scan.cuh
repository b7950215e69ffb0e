// The block-level body of the ADC top-k scans (pq_adc_topk_qbuf.cu,
// pq_adc_topk.cu): a group of up to G query rows, one warp each, whose LUTs
// sit in shared memory, is scanned against a range of one code set, each row
// keeping a running top-k with a bulk selection (topk_select.cuh).
//
// For slot i of the group, row r = rows[i] (or row0 + i when rows is null)
// names its LUT; a row below 0 or at or above `empty_row` marks an empty
// slot, which is written as inf / -1 and not scanned (the dispatch buffer
// passes its sentinel row; an identity map passes a bound no row reaches, so
// every row, the last one included, is scanned). Each candidate's distance
//
//   d = sum_m lut[r, m, codes[n, m]] + q_off[i] + cand_off[n]
//
// is summed over m in order, then q_off, then cand_off, with additions only,
// so nothing contracts into an FMA and the result equals the plain version
// bit for bit. Candidates with ids[n] < 0 are masked; keys are (dist,
// position in the set), so an earlier candidate wins an exact tie, and a NaN
// sorts by its sign, as the plain version on the card (topk_select.cuh).
//
// What bounds the scan is each row's work: m shared-memory gathers and adds
// a candidate, and keeping the k smallest. The design:
//  * each warp owns one occupied slot end to end: its LUT row (loaded by the
//    warp itself), its list and its staging buffer, so the scan needs no
//    block barrier; the block meets only to end the range at its last valid
//    id, read as 16-byte vectors (trailing padding costs no step);
//  * a lane takes one candidate of each 32 and reads its codes straight from
//    device memory in their store dtype, never widened: one 16-byte load when
//    a code row is 16 bytes (NV = 1; the serve path's m = 16 uint8), else
//    element by element (NV = 0). There is no code tile, no barrier around it
//    and no division per element. Four groups of 32 candidates are loaded
//    together to keep loads in flight;
//  * the selection filters each candidate against the row's k-th key and
//    sorts and merges survivors in bulks of 256 (topk_select.cuh);
//  * G is chosen for the most rows an SM holds at once, as the occupancy
//    calculator gives it for the kernel that is launched (shared memory
//    bounds it: a row needs its LUT, its list and its buffer), the larger G
//    on a tie (fewer blocks, each range end found once for more rows), at
//    most 8. That one plan gives the launch and the launch shape the
//    wrappers report.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"
#include "topk_select.cuh"

namespace adcscan {

using topksel::kAllLanes;
using topksel::Selector;

using scancommon::align16;
using scancommon::code_vectors;
using scancommon::kMaxSmem;
using scancommon::Plan;

constexpr int kMaxGroup = 8;  // rows (warps) a block at most
constexpr int kUnroll = 4;    // groups of 32 candidates loaded together
constexpr size_t kHead = 16;  // the block's range end

// Shared memory of one row: its LUT, its list and its buffer.
__host__ __device__ inline size_t row_smem(int m, int ks, int k) {
  return align16((size_t)m * ks * 4) + topksel::row_bytes(k);
}

inline size_t smem_bytes(int G, int m, int ks, int k) {
  return kHead + (size_t)G * row_smem(m, ks, k);
}

// The group size with the most rows resident on an SM for `kernel` (ties to
// the larger group), from the occupancy calculator. A nonzero `only` (1 to
// kMaxGroup) considers that G alone: its plan, or G = 0 when it does not fit.
template <typename Kernel>
inline Plan plan(Kernel* kernel, int m, int ks, int k, int only = 0) {
  Plan best;
  if (only < 0 || only > kMaxGroup ||
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem) !=
          cudaSuccess)
    return best;
  for (int G = only ? only : 1; G <= (only ? only : kMaxGroup); ++G) {
    const size_t smem = smem_bytes(G, m, ks, k);
    int per_sm = 0;
    if (smem > kMaxSmem ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * G, smem) !=
            cudaSuccess)
      break;
    if (per_sm > 0 && G * per_sm >= best.G * best.per_sm) best = {G, smem, per_sm};
  }
  return best;
}

// The sum over m of one candidate's LUT terms, from its NV code vectors.
// (Written for NV vectors, as an array passed by reference: on an H100 the
// same sum over one vector passed by value ran slower, PERF.md §6.)
template <typename CT, int NV>
__device__ __forceinline__ float sum_vec(const float* __restrict__ L, int ks,
                                         const uint4 (&cv)[NV > 0 ? NV : 1]) {
  constexpr int P = 16 / sizeof(CT);  // codes a vector
  constexpr int B = 8 * sizeof(CT);   // bits a code
  float acc = 0.f;
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    const unsigned w[4] = {cv[n].x, cv[n].y, cv[n].z, cv[n].w};
#pragma unroll
    for (int t = 0; t < P; ++t) {
      const int j = n * P + t;
      const unsigned code = (w[t / (P / 4)] >> (B * (t % (P / 4)))) & ((1u << B) - 1);
      const float x = L[j * ks + code];
      acc = j == 0 ? x : acc + x;
    }
  }
  return acc;
}

// The same, reading the m codes of row `row` element by element.
template <typename CT>
__device__ __forceinline__ float sum_row(const float* __restrict__ L, int m, int ks,
                                         const CT* __restrict__ row) {
  float acc = L[__ldg(row)];
  for (int j = 1; j < m; ++j) acc += L[j * ks + __ldg(row + j)];
  return acc;
}

// Scan candidates [c_lo, c_hi) of one set (codes cb [*, m], ids ib, offsets
// cob or null) for the group's ns slots and write slot i's list to
// od / oi [i * k, (i + 1) * k): the id ib[position] (-1 beside a distance
// that is not finite, as the plain version); inf / -1 past a list's length. qob [ns] (or null) is the group's per-slot offset.
// Every thread of the block (32 * G, G >= ns) calls this. NV = 1 needs
// 16-byte aligned code rows of 16 bytes.
template <typename CT, int NV>
__device__ void scan_group(unsigned char* smem, const float* __restrict__ lut, int m, int ks,
                           const int* __restrict__ rows, size_t row0, int ns, int empty_row,
                           const float* __restrict__ qob, const CT* __restrict__ cb,
                           const int* __restrict__ ib, const float* __restrict__ cob,
                           int c_lo, int c_hi, int k, float* __restrict__ od,
                           int* __restrict__ oi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto row_of = [&](int i) { return rows ? rows[i] : (int)(row0 + i); };

  // the group's occupied slots; warp w scans the w-th
  int r_lane = -1;
  if (lane < ns) r_lane = row_of(lane);
  const bool occ_lane = lane < ns && r_lane >= 0 && r_lane < empty_row;
  unsigned occ = __ballot_sync(kAllLanes, occ_lane);
  const int n_occ = __popc(occ);

  // empty slots: warp w writes slot w
  if (warp < ns && !((occ >> warp) & 1u))
    scancommon::fill_empty(od + (size_t)warp * k, oi + (size_t)warp * k, k, lane);
  if (n_occ == 0) return;  // the whole block leaves together

  // end the range at its last valid id (the block's only barriers)
  const int c_end = scancommon::range_end(reinterpret_cast<int*>(smem), ib, c_lo, c_hi);
  if (warp >= n_occ) return;

  for (int t = 0; t < warp; ++t) occ &= occ - 1;
  const int slot = __ffs(occ) - 1;
  const int r = __shfl_sync(kAllLanes, r_lane, slot);
  const float qo = qob ? qob[slot] : 0.f;

  unsigned char* mine = smem + kHead + (size_t)warp * row_smem(m, ks, k);
  float* L = reinterpret_cast<float*>(mine);
  {  // this row's LUT
    const int mks = m * ks;
    const float* src = lut + (size_t)r * mks;
    if ((mks & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
#pragma unroll 8
      for (int e = lane; e < mks / 4; e += 32)
        reinterpret_cast<float4*>(L)[e] = __ldg(reinterpret_cast<const float4*>(src) + e);
    } else {
      for (int e = lane; e < mks; e += 32) L[e] = __ldg(src + e);
    }
  }
  Selector sel;
  sel.init(mine + align16((size_t)m * ks * 4), k);
  __syncwarp();

  for (int c0 = c_lo; c0 < c_end; c0 += 32 * kUnroll) {
    int id[kUnroll];
    float co[kUnroll];
    uint4 cv[kUnroll][NV > 0 ? NV : 1];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * 32 + lane;
      const bool in = c < c_end;
      id[u] = in ? __ldg(ib + c) : -1;
      co[u] = in && cob ? __ldg(cob + c) : 0.f;
      if (NV > 0 && in) {
        const uint4* src = reinterpret_cast<const uint4*>(cb + (size_t)c * m);
#pragma unroll
        for (int n = 0; n < NV; ++n) cv[u][n] = __ldg(src + n);
      }
    }
    bool any = false;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) any |= id[u] >= 0;
    if (!__any_sync(kAllLanes, any)) continue;  // no valid candidate here
    float d[kUnroll];  // all distances first: their gathers overlap
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      d[u] = 0.f;
      if (id[u] >= 0) {
        const int c = c0 + u * 32 + lane;
        d[u] = NV > 0 ? sum_vec<CT, NV>(L, ks, cv[u]) : sum_row(L, m, ks, cb + (size_t)c * m);
        if (qob) d[u] += qo;
        if (cob) d[u] += co[u];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      sel.offer(id[u] >= 0, topksel::pack(d[u], c0 + u * 32 + lane), lane);
  }
  sel.flush(lane);
  sel.store(od + (size_t)slot * k, oi + (size_t)slot * k, ib, lane);
}

}  // namespace adcscan
