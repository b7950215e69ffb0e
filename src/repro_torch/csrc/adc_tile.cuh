// The block-level body of the flat ADC kernels (pq_adc.cu, the flat scan of
// pq_adc_topk.cu): the LUTs of R query rows are staged in shared memory and
// read by gathers in which the lanes of a warp share a candidate and differ
// in query row.
//
// Each distance
//
//   d[q, n] = sum_m lut[q, m, codes[n, m]]
//
// is summed over m in order with additions only, so nothing contracts into
// an FMA and the result equals the plain version bit for bit.
//
// What bounds both kernels on an H100 is the gathers: Q·N·m 4-byte reads
// from shared memory, which serves 32 banks a clock on each SM. A gather in
// which each lane takes its own candidate reads 32 random codes of one query
// row; its bank is the code mod 32, and uniform 8-bit codes take about 3.15
// wavefronts a gather in place of one. The design:
//  * a block stages the LUTs of R query rows in R / V slabs of V rows
//    interleaved (V = 4 once R >= 4: one 16-byte gather reads a code's
//    entries of four rows), slabs at a stride S ≡ 32 / (R / V) (mod 32);
//    lane l takes slab l mod (R / V) and the candidates of group
//    l / (R / V), so the lanes that read one code land in different banks,
//    and only lanes of different candidates can meet in a bank (R = 8 at
//    m = 16, ks = 256: 2.11 wavefronts a 32-word gather for uniform codes;
//    R = 32, at ks = 16 say, none);
//  * a lane takes T consecutive candidates, loads each one's code row once
//    (one 16-byte load when a row is 16 bytes and the base is aligned, NV =
//    1; else element by element, NV = 0), the lanes of a candidate reading
//    one address; the next tile's codes are loaded before this tile's
//    gathers;
//  * R, the warps a block and the blocks an SM come from the occupancy
//    calculator for the kernel launched (plan): the largest R whose block
//    keeps at least kMinWarps warps resident on an SM, down to R = 1; a
//    launch is refused only when one row's LUT (and lists) does not fit;
//  * row groups alone rarely fill the card evenly, so the candidates are
//    split into ranges of whole tiles of 256 (splits_for): the fewest that
//    leave the last wave of blocks at least 98% full.
// The top-k scan keeps one list of the k smallest keys a row in each block
// (RowsSelector, on topk_select.cuh's lists and merge): a lane filters its
// distances against their rows' bounds in registers, one vote a tile, and
// offers only those that may pass, so only survivors touch shared memory;
// they wait in a buffer of their warp's, merged into the rows' lists a kBuf
// at a time. A row's bound is the least k-th key any of its lists has
// reached, kept in device memory for every block of the row.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "scan_common.cuh"
#include "topk_select.cuh"

namespace adctile {

using scancommon::align16;
using scancommon::code_vectors;
using scancommon::kAllLanes;
using scancommon::kMaxSmem;
using topksel::kNone;

constexpr int kTileN = 256;                      // a candidate range is whole tiles of 256
constexpr int kMaxWarps = 16;                    // warps a block at most
constexpr int kMinWarps = 8;                     // warps an SM that R may not go below
constexpr int kMaxSplits = 64;                   // candidate ranges at most

// V floats read as one (V = 1, 2, 4), and what a sum needs of them.
template <int V> struct Vec;
template <> struct Vec<1> { using T = float; };
template <> struct Vec<2> { using T = float2; };
template <> struct Vec<4> { using T = float4; };

__device__ __forceinline__ float vadd(float a, float b) { return a + b; }
__device__ __forceinline__ float2 vadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float4 vadd(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float part(float a, int) { return a; }
__device__ __forceinline__ float part(float2 a, int i) { return i ? a.y : a.x; }
__device__ __forceinline__ float part(float4 a, int i) {
  return i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
}

// The stage: R rows in R / V slabs of V rows interleaved (entry (j, code) of
// a slab's rows is V consecutive floats at (j·ks + code)·V, read as one),
// slabs strided by S = V·m·ks + pad with S ≡ 32 / (R / V) (mod 32). Lane l
// takes slab l mod (R / V) and candidate group l / (R / V); the slabs' lanes
// that read one code land in different banks.
__host__ __device__ inline int slab_stride(int m, int ks, int R, int V) {
  return V * m * ks + ((32 / (R / V) - V * m * ks) & 31);
}

// V rows a slab at R rows a block: 4 (one 16-byte gather reads a code's
// entries of four rows) once R allows it.
__host__ __device__ constexpr int slab_rows(int R) { return R < 4 ? R : 4; }

__host__ __device__ inline size_t stage_bytes(int R, int V, int m, int ks) {
  return align16((size_t)(R / V) * slab_stride(m, ks, R, V) * 4);
}

// A launch: rows a block (R = 1 << lgR; lgR < 0 when nothing fits), warps a
// block, blocks resident on an SM, shared memory a block.
struct Plan {
  int lgR = -1;
  int warps = 0;
  int per_sm = 0;
  size_t smem = 0;
};

// The plan for the kernel `kernel_of(R)`, whose block needs smem_of(R, W)
// bytes: the largest R at which some W keeps kMinWarps warps resident on an
// SM (at that R the W with the most, ties to the larger W); where no R does,
// the plan with the most resident warps.
template <typename KernelOf, typename Smem>
inline Plan plan(KernelOf kernel_of, Smem smem_of) {
  Plan any;
  for (int lg = 5; lg >= 0; --lg) {
    Plan best;
    const auto kernel = kernel_of(1 << lg);
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem) != cudaSuccess)
      return any;
    for (int W = 1; W <= kMaxWarps; W *= 2) {
      const size_t smem = smem_of(1 << lg, W);
      int per_sm = 0;
      if (smem > kMaxSmem ||
          cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * W, smem) !=
              cudaSuccess)
        break;
      if (per_sm > 0 && per_sm * W >= best.per_sm * best.warps) best = {lg, W, per_sm, smem};
    }
    if (best.per_sm * best.warps >= kMinWarps) return best;
    if (best.per_sm * best.warps > any.per_sm * any.warps) any = best;
  }
  return any;
}

// Candidate ranges for `groups` row groups over N candidates: 1 when the
// groups leave the last wave at least 98% full, else the fewest ranges that
// do (at most `most`), else the ranges that fill it best.
inline int splits_for(const Plan& p, long long groups, long long N, int most) {
  int dev = 0, sms = 0;
  if (p.lgR < 0 || groups == 0 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 1;
  const long long slots = (long long)p.per_sm * sms;
  const long long tiles = (N + kTileN - 1) / kTileN;
  if (most > tiles) most = tiles > 1 ? (int)tiles : 1;
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= most; ++s) {
    const long long blocks = groups * s;
    const double fill = (double)blocks / (double)(((blocks + slots - 1) / slots) * slots);
    if (fill > best_fill + 1e-9) { best = s; best_fill = fill; }
    if (fill >= 0.98) break;
  }
  return best;
}

// Range `split` of `splits` over N candidates: whole tiles of kTileN.
__device__ __forceinline__ void range_of(int N, int split, int splits, int& lo, int& hi) {
  const long long tiles = (N + kTileN - 1) / kTileN;
  lo = (int)min((long long)N, tiles * split / splits * kTileN);
  hi = (int)min((long long)N, tiles * (split + 1) / splits * kTileN);
}

// Stage rows q0 .. q0 + nr - 1 of lut [*, mks] as R / V slabs at stride S;
// the whole block calls this.
__device__ __forceinline__ void stage_rows(float* __restrict__ st, const float* __restrict__ lut,
                                           size_t q0, int nr, int mks, int S, int V) {
  for (int r = 0; r < nr; ++r) {
    const float* src = lut + (q0 + r) * mks;
    float* dst = st + (size_t)(r / V) * S + r % V;
    for (int e = threadIdx.x; e < mks; e += blockDim.x) dst[(size_t)V * e] = __ldg(src + e);
  }
}

// One candidate's sums over m (V rows) from its 16-byte code row v.
template <typename CT, int V>
__device__ __forceinline__ typename Vec<V>::T sum_vec(const typename Vec<V>::T* __restrict__ L,
                                                      int ks, const uint4& v) {
  constexpr int P = 16 / sizeof(CT);  // codes a row
  constexpr int B = 8 * sizeof(CT);   // bits a code
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  typename Vec<V>::T acc;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const unsigned code = (w[j / (P / 4)] >> (B * (j % (P / 4)))) & ((1u << B) - 1);
    const typename Vec<V>::T x = L[j * ks + code];
    acc = j == 0 ? x : vadd(acc, x);
  }
  return acc;
}

// The same from the m codes of `row`, element by element.
template <typename CT, int V>
__device__ __forceinline__ typename Vec<V>::T sum_row(const typename Vec<V>::T* __restrict__ L,
                                                      int m, int ks, const CT* __restrict__ row) {
  typename Vec<V>::T acc = L[__ldg(row)];
  for (int j = 1; j < m; ++j) acc = vadd(acc, L[j * ks + __ldg(row + j)]);
  return acc;
}

// A lane's code rows for candidates c .. c + T - 1 (below hi), NV = 1.
template <typename CT, int T>
__device__ __forceinline__ void load_codes(const CT* __restrict__ codes, int c, int hi,
                                           uint4 (&cv)[T]) {
#pragma unroll
  for (int t = 0; t < T; ++t)
    cv[t] = c + t < hi ? __ldg(reinterpret_cast<const uint4*>(codes) + (c + t))
                       : make_uint4(0, 0, 0, 0);
}

// The scan of one lane over its warp's tiles of [lo, hi): for each tile,
// `before(c)` (loads that do not wait on the gathers), then the lane's T
// sums of its slab L (candidates c .. c + T - 1) go to `take(c, acc)`. A
// warp tile is span = (32 / slabs)·T candidates; warp w takes tiles w,
// w + W, ... . The next tile's codes are loaded before this tile's gathers.
// Every lane of the warp calls this.
template <typename CT, int NV, int V, int T, typename Before, typename Take>
__device__ __forceinline__ void scan(const typename Vec<V>::T* __restrict__ L, int m, int ks,
                                     const CT* __restrict__ codes, int lo, int hi, int g,
                                     int span, int warp, int W, Before before, Take take) {
  int c0 = lo + warp * span;
  if (NV > 0) {
    uint4 cv[T];
    load_codes<CT, T>(codes, c0 + g * T, hi, cv);
    for (; c0 < hi; c0 += W * span) {
      uint4 next[T];
      load_codes<CT, T>(codes, c0 + W * span + g * T, hi, next);
      before(c0 + g * T);
      typename Vec<V>::T acc[T];
#pragma unroll
      for (int t = 0; t < T; ++t) acc[t] = sum_vec<CT, V>(L, ks, cv[t]);
      take(c0 + g * T, acc);
#pragma unroll
      for (int t = 0; t < T; ++t) cv[t] = next[t];
    }
  } else {
    for (; c0 < hi; c0 += W * span) {
      const int c = c0 + g * T;
      before(c);
      typename Vec<V>::T acc[T];
#pragma unroll
      for (int t = 0; t < T; ++t)
        acc[t] = sum_row<CT, V>(L, m, ks, codes + (size_t)(c + t < hi ? c + t : lo) * m);
      take(c, acc);
    }
  }
}

// The running top-k of a block's R rows: in shared memory, one sorted list
// of up to k keys a row with its length and a lock (block_bytes), and for
// each warp a staging buffer of kBuf keys that its rows share, with a row
// tag each, and kBuf keys of scratch (warp_bytes). A warp gathers a row's
// buffered keys into its scratch and merges them into the row's list
// (topk_select.cuh's merge) under the row's lock. A key is offered against
// its row's bound `lim` (the least k-th key any list of the row has reached:
// a key at or above it cannot be among the row's k smallest), so a list may
// end shorter than k. The buffer's count is the same in every lane. All 32
// lanes of a warp call every member together.
__host__ __device__ inline size_t block_bytes(int R, int k) {
  return (size_t)R * topksel::list_bytes(k) + align16((size_t)R * 8);
}

__host__ __device__ inline size_t warp_bytes() { return (size_t)topksel::kBuf * 17; }

// RowsSelector::flush, kept out of line (the scan offers from several
// places) with its state passed by value, so the selector itself stays in
// registers: merge the nb buffered keys into their rows' lists, row by
// row, each under its row's lock.
template <typename Done>
__device__ __noinline__ void flush_rows(uint64_t* lists, int* lens, int* locks,
                                        const uint64_t* buf, uint64_t* scratch,
                                        const unsigned char* tag, int k, int R, int nb, int lane,
                                        Done done) {
  const size_t stride = topksel::list_bytes(k) / 8;
  __syncwarp();
  for (int rr = 0; rr < R; ++rr) {
    int n = 0;  // row rr's keys, gathered into scratch in buffer order
    for (int h = 0; h < nb; h += 32) {
      const bool take = h + lane < nb && tag[h + lane] == rr;
      const unsigned m = __ballot_sync(kAllLanes, take);
      if (take) scratch[n + __popc(m & ((1u << lane) - 1))] = buf[h + lane];
      n += __popc(m);
    }
    if (n == 0) continue;
    uint64_t* list = lists + (size_t)rr * stride;
    if (lane == 0)
      while (atomicCAS(locks + rr, 0, 1) != 0) {
      }
    __syncwarp();
    __threadfence_block();
    const int nl = topksel::merge_buffer(list, scratch, k, lens[rr], n, lane);
    if (nl == k) done(rr, list[k - 1]);
    __syncwarp();
    if (lane == 0) {
      lens[rr] = nl;
      __threadfence_block();
      atomicExch(locks + rr, 0);
    }
    __syncwarp();
  }
}

struct RowsSelector {
  uint64_t* lists;     // R lists of list_bytes(k) / 8 keys
  int* lens;           // [R]
  int* locks;          // [R]
  uint64_t* buf;       // [kBuf], nb valid
  uint64_t* scratch;   // [kBuf]
  unsigned char* tag;  // [kBuf] the row of each buffered key
  int k, R;
  int nb;  // keys in the buffer

  // The block's part at `rows` (block_bytes(R, k)), set up by init_rows
  // before a block barrier; this warp's at `mine` (warp_bytes()).
  __device__ __forceinline__ void init(unsigned char* rows, unsigned char* mine, int k_, int R_) {
    k = k_;
    R = R_;
    lists = reinterpret_cast<uint64_t*>(rows);
    lens = reinterpret_cast<int*>(rows + (size_t)R * topksel::list_bytes(k));
    locks = lens + R;
    buf = reinterpret_cast<uint64_t*>(mine);
    scratch = buf + topksel::kBuf;
    tag = reinterpret_cast<unsigned char*>(scratch + topksel::kBuf);
    nb = 0;
  }

  __device__ __forceinline__ void init_rows() const {
    for (int r = threadIdx.x; r < R; r += blockDim.x) lens[r] = locks[r] = 0;
  }

  __device__ __forceinline__ uint64_t* list(int r) const {
    return lists + (size_t)r * (topksel::list_bytes(k) / 8);
  }

  // Merge the buffer into the rows' lists; `done(r, kth)` is called for
  // each row whose list is full after a merge.
  template <typename Done>
  __device__ __forceinline__ void flush(int lane, Done done) {
    flush_rows(lists, lens, locks, buf, scratch, tag, k, R, nb, lane, done);
    nb = 0;
  }

  // Offer each lane's key of row `row` (where ok and below lim).
  template <typename Done>
  __device__ __forceinline__ void offer(bool ok, uint64_t key, int row, uint64_t lim, int lane,
                                        Done done) {
    const bool pass = ok && key < lim;
    const unsigned mask = __ballot_sync(kAllLanes, pass);
    if (!mask) return;
    if (nb + __popc(mask) > topksel::kBuf) flush(lane, done);
    if (pass) {
      const int i = nb + __popc(mask & ((1u << lane) - 1));
      buf[i] = key;
      tag[i] = (unsigned char)row;
    }
    nb += __popc(mask);
  }
};

// Shared memory of one top-k block: the stage (slabs of V rows), the rows'
// lists, and each warp's buffer.
__host__ __device__ inline size_t topk_smem(int R, int V, int W, int m, int ks, int k) {
  return stage_bytes(R, V, m, ks) + block_bytes(R, k) + (size_t)W * warp_bytes();
}

}  // namespace adctile
