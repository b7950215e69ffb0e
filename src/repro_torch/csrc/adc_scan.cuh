// The block-level body of the ADC top-k scans (pq_adc_topk_qbuf.cu,
// pq_adc_topk.cu): a group of up to G query rows, whose LUTs sit in shared
// memory, is scanned against a range of one code set, each row keeping a
// running top-k list (topk_list.cuh).
//
// For slot i of the group, row r = rows[i] (or row0 + i when rows is null)
// names its LUT; a row below 0 or at or above `empty_row` marks an empty
// slot, which is flushed as inf / -1 and not scanned (the dispatch buffer
// passes its sentinel row; an identity map passes a bound no row reaches, so
// every row, the last one included, is scanned). Each candidate's distance
//
//   d = sum_m lut[r, m, codes[n, m]] + q_off[i] + cand_off[n]
//
// is summed over m in order, then q_off, then cand_off, with additions only,
// so nothing contracts into an FMA and the result equals the plain version
// bit for bit. Candidates with ids[n] < 0 are masked; lists are keyed by
// (dist, position in the set), so an earlier candidate wins an exact tie.
//
// Candidates go in tiles of 256, one per thread; a tile's codes are read
// coalesced in their store dtype (uint8 or uint16, never widened) and kept
// transposed in shared memory; tiles with no valid id are skipped. Each
// thread sums its candidate for all G rows in registers; warp w then keeps
// row w's list in shared memory. G is the largest of 8, 4, 2, 1 whose shared
// memory fits in the 227 KB a block can opt into.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "topk_list.cuh"

namespace adcscan {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileN = kThreads;     // candidates per tile, one per thread
constexpr int kMaxGroup = kWarps;    // one warp keeps one row's list
constexpr size_t kMaxSmem = 232448;  // 227 KB, the most a block can opt into

inline size_t smem_bytes(int G, int m, int ks, int k, int code_size) {
  return 4 * ((size_t)G * m * ks      // lut_s: the group's LUT rows
              + (size_t)G * kTileN     // dt: distance tile
              + 2 * (size_t)G * k      // Ld, Lc: running lists
              + kTileN                 // cid
              + 3 * (size_t)G + 1)     // occ_slot, occ_row, qo, n_occ
         + (size_t)m * kTileN * code_size;  // codes_s: transposed code tile
}

inline int pick_group(int m, int ks, int k, int code_size) {
  int G = kMaxGroup;
  while (G > 1 && smem_bytes(G, m, ks, k, code_size) > kMaxSmem) G >>= 1;
  return G;
}

// Scan candidates [c_lo, c_hi) of one set (codes cb [*, m], ids ib, offsets
// cob or null) for the group's ns slots and write slot i's list to
// od / oi [i * k, (i + 1) * k): the id ib[position], or the position itself
// when write_ids is false; inf / -1 past a list's length. qob [ns] (or null)
// is the group's per-slot offset. Every thread of the block calls this.
template <typename CT, int G>
__device__ void scan_group(float* smem, const float* __restrict__ lut, int m, int ks,
                           const int* __restrict__ rows, size_t row0, int ns, int empty_row,
                           const float* __restrict__ qob, const CT* __restrict__ cb,
                           const int* __restrict__ ib, const float* __restrict__ cob,
                           int c_lo, int c_hi, int k, float* __restrict__ od,
                           int* __restrict__ oi, bool write_ids) {
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

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  auto row_of = [&](int i) { return rows ? rows[i] : (int)(row0 + i); };

  // the group's occupied slots, in slot order; empty slots flush as inf / -1
  if (tid == 0) {
    int n = 0;
    for (int i = 0; i < ns; ++i) {
      const int r = row_of(i);
      if (r >= 0 && r < empty_row) {
        occ_slot[n] = i;
        occ_row[n] = r;
        qo[n] = qob ? qob[i] : 0.f;
        ++n;
      }
    }
    *n_occ_s = n;
  }
  for (int e = tid; e < ns * k; e += kThreads) {
    const int r = row_of(e / k);
    if (!(r >= 0 && r < empty_row)) { od[e] = CUDART_INF_F; oi[e] = -1; }
  }
  __syncthreads();
  const int n_occ = *n_occ_s;
  if (n_occ == 0) return;

  for (int i = 0; i < n_occ; ++i) {
    const float* src = lut + (size_t)occ_row[i] * mks;
    for (int e = tid; e < mks; e += kThreads) lut_s[(size_t)i * mks + e] = src[e];
  }

  // warp w keeps the list of occupied slot w; (td, tc) is its k-th key
  float* Lds = Ld + (size_t)warp * k;
  int* Lcs = Lc + (size_t)warp * k;
  int len = 0;
  float td = CUDART_INF_F;
  int tc = 0;

  for (int c0 = c_lo; c0 < c_hi; c0 += kTileN) {
    const int c = c0 + tid;
    const int id = c < c_hi ? ib[c] : -1;
    cid[tid] = id;
    if (!__syncthreads_or(id >= 0)) continue;  // no valid candidate in this tile

    const int nt = min(kTileN, c_hi - c0);
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
        if (qob) v += qo[g];
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
        od[o + i] = Lds[i];
        oi[o + i] = write_ids ? ib[Lcs[i]] : Lcs[i];
      } else {
        od[o + i] = CUDART_INF_F;
        oi[o + i] = -1;
      }
    }
  }
}

}  // namespace adcscan
