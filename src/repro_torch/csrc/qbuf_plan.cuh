// The work plan the dispatch-buffer scans share (l2_topk_qbuf.cu over float
// rows, l2u8_topk_qbuf.cu over byte rows): each bucket's empty slots written
// and its occupied slots counted, those cut into work items for persistent
// blocks, and the workspace that holds them and the split groups' partial
// lists. l2_topk_qbuf.cu says why the work is cut so. Each scan wraps the
// bodies here in kernels of its own name, so a profile tells the scans
// apart, and takes its items in a loop of its own.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "l2_scan.cuh"
#include "scan_common.cuh"

namespace qbufplan {

using l2scan::kRangeUnit;
using scancommon::align16;
using scancommon::fill_empty;
using scancommon::Plan;

constexpr long long kMinSplit = 16LL * 512;  // (row, candidate) pairs an item may always take
constexpr int kShareDiv = 4;                 // an item holds at most 1/4 of a block's share
constexpr int kCountThreads = 256;
constexpr int kPlanThreads = 128;
constexpr int kItemInts = 8;  // b, first slot, rows, c_lo, c_hi, ranges, first list, range
// int counters, then the total work (8 bytes), then the arrivals
enum { kFront, kBack, kPoolUsed, kNext, kWorkAt = 4, kCounterInts = 8 };

// The workspace one launch needs: counters and arrivals (zeroed each
// launch), each bucket's occupied count and valid end, the work items, and
// the pool of partial lists.
struct Workspace {
  long long pool_lists, item_cap;
  size_t occ, end, items, pd, pc, zeroed, total;
  Workspace(int B, int S, int k, int G, int blocks) {
    pool_lists = 2LL * kShareDiv * G * blocks;
    item_cap = (long long)B * ((S + G - 1) / G) + pool_lists;
    zeroed = align16((kCounterInts + (size_t)pool_lists) * 4);
    occ = zeroed;
    end = align16(occ + (size_t)B * 4);
    items = align16(end + (size_t)B * 4);
    pd = align16(items + (size_t)item_cap * kItemInts * 4);
    pc = align16(pd + (size_t)pool_lists * k * 4);
    total = align16(pc + (size_t)pool_lists * k * 4);
  }
};

// The count kernel's body, one block of kCountThreads a bucket: the empty
// slots' rows, the occupied count, the valid end, and the bucket's share of
// the total work.
__device__ __forceinline__ void count_bucket(const int* __restrict__ qbuf, int n_rows, int S,
                                             const int* __restrict__ ids, int C, int k,
                                             float* __restrict__ od, int* __restrict__ oi,
                                             int* __restrict__ ctr, int* __restrict__ occ,
                                             int* __restrict__ end) {
  __shared__ int counts[kCountThreads / 32];
  __shared__ int end_slot;
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int empty_row = n_rows - 1;
  const int* qb = qbuf + (size_t)b * S;
  // warp w takes slots [32w, 32w + 32), [32(w + 8), ...): counts the
  // occupied ones and writes inf / -1 to the empty ones, a row at a time
  int n = 0;
  for (int s0 = 32 * warp; s0 < S; s0 += kCountThreads) {
    const int s = s0 + lane;
    const int r = s < S ? __ldg(qb + s) : -1;
    const unsigned occupied = __ballot_sync(scancommon::kAllLanes, r >= 0 && r < empty_row);
    unsigned empty = ~occupied & __ballot_sync(scancommon::kAllLanes, s < S);
    n += __popc(occupied);
    for (; empty; empty &= empty - 1) {
      const size_t row = (size_t)b * S + s0 + __ffs(empty) - 1;
      fill_empty(od + row * k, oi + row * k, k, lane);
    }
  }
  if (lane == 0) counts[warp] = n;
  __syncthreads();
  int n_occ = 0;
  for (int w = 0; w < kCountThreads / 32; ++w) n_occ += counts[w];
  // the whole block takes the same branch
  const int e = n_occ > 0 ? scancommon::range_end(&end_slot, ids + (size_t)b * C, 0, C) : 0;
  if (threadIdx.x == 0) {
    occ[b] = n_occ;
    end[b] = e;
    atomicAdd(reinterpret_cast<unsigned long long*>(ctr + kWorkAt),
              (unsigned long long)n_occ * (unsigned long long)e);
  }
}

// The plan kernel's body, a thread a bucket: its work items, and their
// ranges' partial lists.
__device__ __forceinline__ void plan_bucket(int B, int G, int blocks, long long pool_lists,
                                            long long item_cap, const int* __restrict__ occ,
                                            const int* __restrict__ end, int* __restrict__ ctr,
                                            int* __restrict__ items) {
  const int b = blockIdx.x * kPlanThreads + threadIdx.x;
  if (b >= B) return;
  const long long total = (long long)*reinterpret_cast<const unsigned long long*>(ctr + kWorkAt);
  const long long share = (long long)kShareDiv * blocks;
  const long long target = max(kMinSplit, (total + share - 1) / share);
  const int n_occ = occ[b], e = end[b];
  const long long units = (e + kRangeUnit - 1) / kRangeUnit;
  for (int s_lo = 0; s_lo < n_occ; s_lo += G) {
    const int nq = min(G, n_occ - s_lo);
    const long long work = (long long)nq * e;
    int R = work > target ? (int)min(units, (work + target - 1) / target) : 1, list0 = -1;
    if (R > 1) {
      list0 = atomicAdd(ctr + kPoolUsed, nq * R);
      if (list0 + (long long)nq * R > pool_lists) R = 1;  // never, by the pool's bound
    }
    // items above half the target from the front, the rest from the back
    const bool heavy = 2 * (work / R) > target;
    const long long at =
        heavy ? atomicAdd(ctr + kFront, R) : item_cap - R - atomicAdd(ctr + kBack, R);
    for (int r = 0; r < R; ++r) {
      const int c_lo = (int)min((long long)e, units * r / R * kRangeUnit);
      const int c_hi = (int)min((long long)e, units * (r + 1) / R * kRangeUnit);
      int4* it = reinterpret_cast<int4*>(items + (at + r) * kItemInts);
      it[0] = make_int4(b, s_lo, nq, c_lo);
      it[1] = make_int4(c_hi, R, R > 1 ? list0 : -1, r);
    }
  }
}

// The scan's blocks: as many as the card holds at once.
inline cudaError_t scan_blocks(const Plan& p, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = sms * p.per_sm;
  return err;
}

// Zero the counters of `ws` and run a scan's count and plan kernels (its
// own, launched with kCountThreads and kPlanThreads threads): the empty
// slots' rows, and the work items.
template <typename CountK, typename PlanK>
cudaError_t plan_items(CountK* count_kernel, PlanK* plan_kernel, const Plan& p, int blocks,
                       const void* qbuf, int n_rows, int B, int S, const void* ids, int C, int k,
                       void* ws, void* od, void* oi, cudaStream_t st) {
  const Workspace w(B, S, k, p.G, blocks);
  unsigned char* base = (unsigned char*)ws;
  int* ctr = (int*)base;
  cudaError_t err = cudaMemsetAsync(base, 0, w.zeroed, st);
  if (err != cudaSuccess) return err;
  count_kernel<<<B, kCountThreads, 0, st>>>((const int*)qbuf, n_rows, S, (const int*)ids, C, k,
                                            (float*)od, (int*)oi, ctr, (int*)(base + w.occ),
                                            (int*)(base + w.end));
  plan_kernel<<<(B + kPlanThreads - 1) / kPlanThreads, kPlanThreads, 0, st>>>(
      B, p.G, blocks, w.pool_lists, w.item_cap, (const int*)(base + w.occ),
      (const int*)(base + w.end), ctr, (int*)(base + w.items));
  return cudaGetLastError();
}

// out[0] the workspace's bytes, out[1] the byte offset of its items, out[2]
// the items it has room for, out[3] the partial lists its pool holds; zero
// bytes when no group fits a block.
inline void workspace_sizes(const Plan& p, int B, int S, int k, long long* out) {
  int blocks = 0;
  out[0] = out[1] = out[2] = out[3] = 0;
  if (p.G == 0 || scan_blocks(p, &blocks) != cudaSuccess) return;
  const Workspace w(B, S, k, p.G, blocks);
  out[0] = (long long)w.total;
  out[1] = (long long)w.items;
  out[2] = w.item_cap;
  out[3] = w.pool_lists;
}

}  // namespace qbufplan
