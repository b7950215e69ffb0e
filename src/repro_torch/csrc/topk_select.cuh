// A running top-k kept by one warp with a bulk selection, for the ADC scans
// (adc_scan.cuh) and the split scans' merge (topk_merge.cuh): a sorted list
// of up to k keys and a staging buffer of kBuf keys, both in shared memory.
//
// A key packs (dist, position) into one 64-bit unsigned: the distance's bits
// made order-preserving above, the candidate's position below, so one
// integer compare orders by distance and then by position, and an earlier
// candidate wins an exact tie (as the TPU kernels' running merges, which put
// the running list before each new block). Keys are unique, so the k
// smallest are one set in one order, whatever order they arrive in.
//
// `offer` filters 32 candidates against the list's k-th key (no filter while
// the list is short) and appends the survivors to the buffer, compacted with
// a ballot. When the buffer cannot take another 32, and once at the end,
// `flush` sorts it (a bitonic sort in registers, 8 keys a lane) and merges
// it into the list by rank: each list key moves up by the number of new keys
// below it, each new key lands at its index plus the number of list keys
// below it, and what lands at or past k is dropped. The list then refreshes
// its k-th key. A row pays one warp round per 32 candidates, plus one sort
// and one merge per kBuf survivors, in place of one insert (a scan and a
// shift of the list) per survivor.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace topksel {

constexpr unsigned kAllLanes = 0xffffffffu;
constexpr int kBuf = 256;               // staging keys a row
constexpr int kPerLane = kBuf / 32;     // keys a lane holds while sorting
constexpr uint64_t kNone = ~0ull;       // above every key
constexpr int kMoves = 4;               // list chunks a merge moves at once

static_assert(kPerLane == 8, "the sort below assumes 8 keys a lane");

// Bytes of one row's list, 16-byte aligned; its buffer follows.
__host__ __device__ inline size_t list_bytes(int k) { return ((size_t)k * 8 + 15) & ~(size_t)15; }

// Shared memory of one row's list and buffer.
__host__ __device__ inline size_t row_bytes(int k) { return list_bytes(k) + (size_t)kBuf * 8; }

// -0 sorts with +0 (as a float compare has them equal) and comes back as +0.
// A NaN keeps its bits, so it sorts by its sign: after +inf, or before -inf
// when its sign bit is set, as torch.sort on the card puts it (and the JAX
// oracles' top_k(-d); torch.sort on the CPU puts every NaN last). An add on
// the card only makes NaNs with a clear sign bit.
__device__ __forceinline__ uint64_t pack(float d, int pos) {
  unsigned u = __float_as_uint(d == 0.f ? 0.f : d);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((uint64_t)u << 32) | (unsigned)pos;
}

__device__ __forceinline__ float key_dist(uint64_t key) {
  unsigned u = (unsigned)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_pos(uint64_t key) { return (int)(unsigned)key; }

// Keys of a[0, n) below each x[i] (a ascending), for N keys at once: the
// searches take the same steps, so their loads overlap.
template <int N>
__device__ __forceinline__ void rank_in(const uint64_t* a, int n, const uint64_t (&x)[N],
                                        int (&p)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = 0;
  if (n == 0) return;
  for (int step = 1 << (31 - __clz(n)); step > 0; step >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (p[i] + step <= n && a[p[i] + step - 1] < x[i]) p[i] += step;
  }
}

// The same in the sorted buffer: kBuf entries, the unused ones kNone.
template <int N>
__device__ __forceinline__ void rank_in_buf(const uint64_t* b, const uint64_t (&x)[N],
                                            int (&p)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] = 0;
#pragma unroll
  for (int step = kBuf / 2; step > 0; step >>= 1) {
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (b[p[i] + step - 1] < x[i]) p[i] += step;
  }
#pragma unroll
  for (int i = 0; i < N; ++i) p[i] += b[p[i]] < x[i];
}

// Sort the warp's 256 keys ascending; lane l holds keys l * 8 + i in v[i].
// Stage (2^ls, 2^lt) compares keys 2^lt apart within blocks of 2^ls; every
// loop has a fixed count, so all of it unrolls and v stays in registers.
__device__ __forceinline__ void bitonic_sort(uint64_t (&v)[kPerLane], int lane) {
#pragma unroll
  for (int ls = 1; ls <= 8; ++ls) {
#pragma unroll
    for (int lt = ls - 1; lt >= 0; --lt) {
      const int size = 1 << ls, stride = 1 << lt;
      if (stride >= kPerLane) {  // partner in lane ^ (stride / 8), same register
        const int lm = stride / kPerLane;
        const bool keep_min = (((lane * kPerLane) & size) == 0) == ((lane & lm) == 0);
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          const uint64_t y = __shfl_xor_sync(kAllLanes, v[i], lm);
          v[i] = (v[i] < y) == keep_min ? v[i] : y;
        }
      } else {  // partner in the same lane
#pragma unroll
        for (int i = 0; i < kPerLane; ++i) {
          if (i & stride) continue;
          const int j = i | stride;
          const bool up = ((lane * kPerLane + i) & size) == 0;
          const uint64_t a = v[i], b = v[j];
          const bool swap = (b < a) == up;
          v[i] = swap ? b : a;
          v[j] = swap ? a : b;
        }
      }
    }
  }
}

// Merge the nb unsorted keys of buf into the ascending list of len keys,
// keeping the first k; returns the list's new length. Kept out of line: the
// scan offers from several places, and one copy of the sort keeps the
// kernel's code small.
__device__ __noinline__ int merge_buffer(uint64_t* list, uint64_t* buf, int k, int len, int nb,
                                         int lane) {
  __syncwarp();
  uint64_t v[kPerLane];
  {
    const ulonglong2* src = reinterpret_cast<const ulonglong2*>(buf + lane * kPerLane);
#pragma unroll
    for (int t = 0; t < kPerLane / 2; ++t) {
      const ulonglong2 p = src[t];
      v[2 * t] = p.x;
      v[2 * t + 1] = p.y;
    }
#pragma unroll
    for (int i = 0; i < kPerLane; ++i)
      if (lane * kPerLane + i >= nb) v[i] = kNone;
  }
  bitonic_sort(v, lane);
  // where each new key lands: its index plus the list keys below it
  int dst[kPerLane];
  rank_in(list, len, v, dst);
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int e = lane * kPerLane + i;
    dst[i] = e < nb ? e + dst[i] : k;
  }
  __syncwarp();
  {
    ulonglong2* out = reinterpret_cast<ulonglong2*>(buf + lane * kPerLane);
#pragma unroll
    for (int t = 0; t < kPerLane / 2; ++t) out[t] = make_ulonglong2(v[2 * t], v[2 * t + 1]);
  }
  __syncwarp();
  // list keys below the smallest new key stay; the rest move up by the new
  // keys below them, kMoves chunks of 32 at a time from the top, so a move
  // only overwrites keys already read
  const int first = __shfl_sync(kAllLanes, dst[0], 0);
  for (int top = (len - 1) & ~31; len > 0 && top >= (first & ~31); top -= 32 * kMoves) {
    uint64_t x[kMoves];
    int to[kMoves];
#pragma unroll
    for (int j = 0; j < kMoves; ++j) {
      const int i = top - 32 * j + lane;
      x[j] = i >= first && i < len ? list[i] : kNone;
    }
    rank_in_buf(buf, x, to);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kMoves; ++j) {
      const int i = top - 32 * j + lane;
      if (x[j] != kNone && i + to[j] < k) list[i + to[j]] = x[j];
    }
    __syncwarp();
  }
#pragma unroll
  for (int i = 0; i < kPerLane; ++i)
    if (dst[i] < k) list[dst[i]] = v[i];
  __syncwarp();
  return min(len + nb, k);
}

// One warp's running top-k. All 32 lanes call every member together; the
// state is the same in every lane.
struct Selector {
  uint64_t* list;  // [k] ascending, len valid
  uint64_t* buf;   // [kBuf], nb valid, unsorted; 16-byte aligned
  int k;
  int len;
  int nb;
  uint64_t kth;  // keys at or above it cannot enter: list[k - 1], or kNone while len < k

  // The list and buffer at `mem`, row_bytes(k) of 16-byte aligned shared memory.
  __device__ __forceinline__ void init(unsigned char* mem, int k_) {
    list = reinterpret_cast<uint64_t*>(mem);
    buf = reinterpret_cast<uint64_t*>(mem + list_bytes(k_));
    k = k_;
    len = 0;
    nb = 0;
    kth = kNone;
  }

  // Offer the lanes' keys (those with ok set).
  __device__ __forceinline__ void offer(bool ok, uint64_t key, int lane) {
    bool pass = ok && key < kth;
    unsigned mask = __ballot_sync(kAllLanes, pass);
    if (!mask) return;
    if (nb + __popc(mask) > kBuf) {
      flush(lane);
      pass = pass && key < kth;
      mask = __ballot_sync(kAllLanes, pass);
    }
    if (pass) buf[nb + __popc(mask & ((1u << lane) - 1))] = key;
    nb += __popc(mask);
  }

  // Merge the buffer into the list.
  __device__ __forceinline__ void flush(int lane) {
    if (nb == 0) return;
    len = merge_buffer(list, buf, k, len, nb, lane);
    nb = 0;
    if (len == k) kth = list[k - 1];
  }

  // Write the (flushed) list to d / o [k]: each key's distance, and beside
  // it ids[position] (-1 where the distance is not finite), or the position
  // itself when ids is null; inf / -1 past the list's length.
  __device__ __forceinline__ void store(float* __restrict__ d, int* __restrict__ o,
                                        const int* __restrict__ ids, int lane) const {
    for (int i = lane; i < k; i += 32) {
      float dist = CUDART_INF_F;
      int id = -1;
      if (i < len) {
        dist = key_dist(list[i]);
        id = key_pos(list[i]);
        if (ids) id = isfinite(dist) ? __ldg(ids + id) : -1;
      }
      d[i] = dist;
      o[i] = id;
    }
  }
};

}  // namespace topksel
