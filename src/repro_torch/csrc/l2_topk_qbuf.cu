// Dispatch-buffer L2 scan with a running top-k, for sm_90a.
//
// Replaces the TPU kernel `l2_topk_qbuf` (repro/kernels/l2_topk.py,
// `_l2_topk_qbuf_kernel`). For each bucket b (one local partition): gather the
// query rows q_pad[qbuf[b, s]] of its occupied dispatch slots, stream the
// partition's candidates, compute ||q||^2 - 2 q.c + ||c||^2 with f32
// accumulation (bf16 stores are upcast with __bfloat162float), mask ids < 0,
// and keep the k smallest (dist, candidate index) pairs per slot. An earlier
// candidate wins an exact tie, as on the TPU (l2_topk.py:232 puts the running
// list before the new block), so ids agree with a lowest-index-first top-k;
// a valid candidate whose distance is not finite gets id -1, as in the plain
// version.
//
// What bounds it on an H100: the scan must read the used partitions once
// and write the [B, S, k] outputs (~0.18 ms at the main path's widths), and
// do 2*d flops per (occupied slot, valid candidate) pair (~0.12 ms at the
// CUDA-core f32 rate). What keeps it from that is how the work spreads: the
// occupied slots cluster in the big partitions (13,366 valid rows against a
// mean of ~1,000), most of a dispatch buffer's slots are empty, and a block
// that takes more than its share of the work is the kernel's tail (on an
// H100 the time followed the heaviest block's work, PERF.md §6).
//
// What the design does about it, in three kernels:
//  * a count kernel, one block a bucket, writes inf / -1 to the bucket's
//    empty slots (a warp a row, no division), counts its occupied slots
//    with ballots, ends it at its last valid id, and adds its work (occupied
//    slots x valid end) to the total W;
//  * a plan kernel, a thread a bucket, cuts the occupied slots into groups
//    of G (in slot order), each a work item, and cuts a group whose work
//    exceeds the target W / (4 x the scan's blocks) (at least kMinSplit
//    pairs) along its candidates into ranges of whole 256-candidate units,
//    an item each, so that no item holds more than a quarter of a block's
//    share. The split groups' partial lists go to a pool that holds fewer
//    than 8 x G x blocks lists whatever the widths (a split group's nq x R
//    lists are below 2 x G x its work / target), so the scratch does not
//    grow with B, S or the capacity C, and neither the padding past a
//    bucket's valid end nor an empty slot costs a block;
//  * a scan kernel of as many blocks as the card holds at once takes items
//    from the list (those above half the target first) until it is done.
//    Each item runs l2_scan.cuh's body: register-tiled distances of its rows
//    against candidate chunks copied while the one before is computed, and a
//    bulk top-k selection (topk_select.cuh). The block that finishes a split
//    group's last range merges the group's partial lists under the same
//    (dist, position) key (topk_merge.cuh's offer_list) and writes the ids.
// G is 16 or 32, whichever the occupancy calculator lets an SM hold the most
// rows of (the smaller on a tie), unless the caller names one (the autotuner,
// kernels/autotune.py). The launch is refused when not even a group of 16
// fits a block's shared memory, or when the G named does not.

#include <cuda_runtime.h>
#include <stdint.h>

#include "l2_scan.cuh"
#include "topk_merge.cuh"

namespace {

using namespace l2scan;

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

// One block a bucket: the empty slots' rows, the occupied count, the valid
// end, and the bucket's share of the total work.
__global__ void __launch_bounds__(kCountThreads)
l2_topk_qbuf_count_kernel(const int* __restrict__ qbuf, int n_rows, int S,
                          const int* __restrict__ ids, int C, int k, float* __restrict__ od,
                          int* __restrict__ oi, int* __restrict__ ctr, int* __restrict__ occ,
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
    const unsigned occupied = __ballot_sync(kAllLanes, r >= 0 && r < empty_row);
    unsigned empty = ~occupied & __ballot_sync(kAllLanes, s < S);
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

// A thread a bucket: its work items, and their ranges' partial lists.
__global__ void __launch_bounds__(kPlanThreads)
l2_topk_qbuf_plan_kernel(int B, int G, int blocks, long long pool_lists, long long item_cap,
                         const int* __restrict__ occ, const int* __restrict__ end,
                         int* __restrict__ ctr, int* __restrict__ items) {
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

// Merge a split group's partial lists, R a row, into its rows' outputs
// od / oi + outs[i] * k (the bucket's), the ids from ib; every thread of the
// block calls this. Out of line, so the scan's loop keeps its registers.
template <int G>
__device__ __noinline__ void merge_group(unsigned char* smem, int d, int k, int nq, int R,
                                         int list0, const float* __restrict__ pd,
                                         const int* __restrict__ pc, const int* __restrict__ ib,
                                         float* __restrict__ od, int* __restrict__ oi) {
  using Sh = Shape<G>;
  const Layout<G> lay(d, k);
  const int* outs = reinterpret_cast<const int*>(smem + lay.outs);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int m = 0; m < Sh::kRowsPerWarp; ++m) {
    const int i = warp + m * Sh::kWarps;
    if (i >= nq) break;
    Selector sel;
    sel.init(smem + lay.sel + (size_t)i * topksel::row_bytes(k), k);
    for (int r = 0; r < R; ++r) {
      const size_t list = ((size_t)list0 + (size_t)r * nq + i) * k;
      topkmerge::offer_list(sel, pd + list, pc + list, k, lane);
    }
    sel.flush(lane);
    sel.store(od + (size_t)outs[i] * k, oi + (size_t)outs[i] * k, ib, lane);
  }
}

// As many blocks as the card holds at once, each taking work items until
// the list is done.
template <int G, typename T>
__global__ void __launch_bounds__(Shape<G>::kThreads, 32 / G)
l2_topk_qbuf_kernel(const T* __restrict__ q_pad, int n_rows, const int* __restrict__ qbuf,
                    int S, const T* __restrict__ cands, const int* __restrict__ ids, int C,
                    int d, int k, long long item_cap, int* __restrict__ ctr,
                    const int* __restrict__ items, float* __restrict__ od,
                    int* __restrict__ oi, float* __restrict__ pd, int* __restrict__ pc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout<G> lay(d, k);
  int* head = reinterpret_cast<int*>(smem);  // [0] this block's item, [1] whether it merges
  int* outs = reinterpret_cast<int*>(smem + lay.outs);
  int* rows = reinterpret_cast<int*>(smem + lay.rows);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int empty_row = n_rows - 1;
  const int n_front = ctr[kFront], n_items = n_front + ctr[kBack];
  int* arrive = ctr + kCounterInts;
  for (;;) {
    if (tid == 0) head[0] = atomicAdd(ctr + kNext, 1);
    __syncthreads();  // also: the last item's reads of shared memory are done
    const int t = head[0];
    if (t >= n_items) return;  // the whole block leaves together
    const int4* it = reinterpret_cast<const int4*>(
        items + (t < n_front ? t : item_cap - 1 - (t - n_front)) * kItemInts);
    const int4 a = __ldg(it), z = __ldg(it + 1);
    const int b = a.x, s_lo = a.y, nq = a.z, c_lo = a.w, c_hi = z.x, R = z.y, list0 = z.z;
    const int* qb = qbuf + (size_t)b * S;
    if (warp == 0) {  // the group's slots: occupied slots s_lo, ..., s_lo + nq - 1
      int seen = 0;
      for (int s0 = 0; s0 < S && seen < s_lo + nq; s0 += 32) {
        const int s = s0 + lane;
        const int r = s < S ? __ldg(qb + s) : -1;
        const bool occ = r >= 0 && r < empty_row;
        const unsigned mask = __ballot_sync(kAllLanes, occ);
        const int i = seen + __popc(mask & ((1u << lane) - 1u)) - s_lo;
        if (occ && i >= 0 && i < nq) { outs[i] = s; rows[i] = r; }
        seen += __popc(mask);
      }
    }
    const int* ib = ids + (size_t)b * C;
    // when split, this range's lists: first list0 + range * nq, a row each
    const size_t first = R > 1 ? (size_t)list0 + (size_t)z.w * nq : 0;
    scan_group<G, T>(smem, q_pad, true, 0, nq, d, cands + (size_t)b * C * d, ib, c_lo, c_hi, k,
                     R > 1 ? pd : od + (size_t)b * S * k, R > 1 ? pc : oi + (size_t)b * S * k,
                     R == 1, first, R == 1);
    if (R == 1) continue;
    // the block that finishes the group's last range merges its lists
    __threadfence();
    __syncthreads();
    if (tid == 0) head[1] = atomicAdd(arrive + list0, 1) == R - 1;
    __syncthreads();
    if (!head[1]) continue;
    __threadfence();
    merge_group<G>(smem, d, k, nq, R, list0, pd, pc, ib, od + (size_t)b * S * k,
                   oi + (size_t)b * S * k);
  }
}

// G = 0: the occupancy calculator's choice; 16 or 32: that group alone.
template <typename T>
Plan plan_for(int d, int k, int G) {
  if (G != 0 && G != 16 && G != 32) return Plan{};
  return plan(l2_topk_qbuf_kernel<16, T>, l2_topk_qbuf_kernel<32, T>, d, k, false, G);
}

Plan plan_for(int d, int k, int itemsize, int G) {
  return itemsize == 2 ? plan_for<__nv_bfloat16>(d, k, G) : plan_for<float>(d, k, G);
}

// The scan's blocks: as many as the card holds at once.
cudaError_t scan_blocks(const Plan& p, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = sms * p.per_sm;
  return err;
}

// The count and plan kernels: zero the counters, write the empty slots' rows
// and the work items into `ws`.
cudaError_t plan_items(const Plan& p, int blocks, const void* qbuf, int n_rows, int B, int S,
                       const void* ids, int C, int k, void* ws, void* od, void* oi,
                       cudaStream_t st) {
  const Workspace w(B, S, k, p.G, blocks);
  unsigned char* base = (unsigned char*)ws;
  int* ctr = (int*)base;
  cudaError_t err = cudaMemsetAsync(base, 0, w.zeroed, st);
  if (err != cudaSuccess) return err;
  l2_topk_qbuf_count_kernel<<<B, kCountThreads, 0, st>>>(
      (const int*)qbuf, n_rows, S, (const int*)ids, C, k, (float*)od, (int*)oi, ctr,
      (int*)(base + w.occ), (int*)(base + w.end));
  l2_topk_qbuf_plan_kernel<<<(B + kPlanThreads - 1) / kPlanThreads, kPlanThreads, 0, st>>>(
      B, p.G, blocks, w.pool_lists, w.item_cap, (const int*)(base + w.occ),
      (const int*)(base + w.end), ctr, (int*)(base + w.items));
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q_pad, int n_rows, const void* qbuf, int B, int S, const void* cands,
           const void* ids, int C, int d, int k, int G, void* ws, void* od, void* oi,
           void* stream) {
  const Plan p = plan_for<T>(d, k, G);
  if (p.G == 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  int blocks = 0;
  cudaError_t err = scan_blocks(p, &blocks);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  err = plan_items(p, blocks, qbuf, n_rows, B, S, ids, C, k, ws, od, oi, st);
  if (err != cudaSuccess) return (int)err;
  const Workspace w(B, S, k, p.G, blocks);
  unsigned char* base = (unsigned char*)ws;
  auto kernel = p.G == 16 ? l2_topk_qbuf_kernel<16, T> : l2_topk_qbuf_kernel<32, T>;
  kernel<<<blocks, 16 * p.G, p.smem, st>>>(
      (const T*)q_pad, n_rows, (const int*)qbuf, S, (const T*)cands, (const int*)ids, C, d, k,
      w.item_cap, (int*)base, (const int*)(base + w.items), (float*)od, (int*)oi,
      (float*)(base + w.pd), (int*)(base + w.pc));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch at these widths on the current device, for a store of
// `itemsize`-byte elements (4: f32, 2: bf16): dispatch slots a group (16 or
// 32; 0 when a group of 16 exceeds a block's shared memory), the shared
// memory a scan block needs (a group of 16's when none fits; above 232448
// the launch is refused), and blocks resident on an SM (the scan kernel
// launches that many for every SM).
int l2_topk_qbuf_group(int d, int k, int itemsize) { return plan_for(d, k, itemsize, 0).G; }

long long l2_topk_qbuf_smem_bytes(int d, int k, int itemsize) {
  return (long long)(plan_for(d, k, itemsize, 0).G == 32 ? smem_bytes<32>(d, k)
                                                         : smem_bytes<16>(d, k));
}

int l2_topk_qbuf_blocks_per_sm(int d, int k, int itemsize) {
  return plan_for(d, k, itemsize, 0).per_sm;
}

// The launch with the group G (16 or 32) named: out[0] G, or 0 when that
// group does not fit a block (or is neither 16 nor 32), out[1] the shared
// memory a block of G needs, out[2] blocks resident on an SM.
void l2_topk_qbuf_plan_group(int d, int k, int itemsize, int G, long long* out) {
  const Plan p = plan_for(d, k, itemsize, G);
  out[0] = p.G;
  out[1] = (long long)(G == 32 ? smem_bytes<32>(d, k) : smem_bytes<16>(d, k));
  out[2] = p.per_sm;
}

// The workspace of a launch over B buckets of S slots with the group G (0:
// the calculator's) on the current device: out[0] its bytes, out[1] the
// byte offset of its work items (kItemInts int32 each: bucket, first
// occupied slot, rows, c_lo, c_hi, ranges of the group, first partial list
// or -1, range), out[2] the items it
// has room for (those above half the target from the front, the rest from
// the back), out[3] the partial lists its pool holds. Zero bytes when no
// group fits a block.
void l2_topk_qbuf_workspace(int B, int S, int d, int k, int itemsize, int G, long long* out) {
  const Plan p = plan_for(d, k, itemsize, G);
  int blocks = 0;
  out[0] = out[1] = out[2] = out[3] = 0;
  if (p.G == 0 || scan_blocks(p, &blocks) != cudaSuccess) return;
  const Workspace w(B, S, k, p.G, blocks);
  out[0] = (long long)w.total;
  out[1] = (long long)w.items;
  out[2] = w.item_cap;
  out[3] = w.pool_lists;
}

// The count and plan kernels alone, into `ws` (its counters first, int32:
// items from the front, items from the back, partial lists used; then the
// total work as an int64 at byte 16), for inspection; they also write the
// empty slots' rows of od / oi. Returns a cudaError_t.
int l2_topk_qbuf_plan(const void* qbuf, int n_rows, int B, int S, const void* ids, int C, int d,
                      int k, int itemsize, void* ws, void* od, void* oi, void* stream) {
  const Plan p = plan_for(d, k, itemsize, 0);
  if (p.G == 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  int blocks = 0;
  const cudaError_t err = scan_blocks(p, &blocks);
  if (err != cudaSuccess) return (int)err;
  return (int)plan_items(p, blocks, qbuf, n_rows, B, S, ids, C, k, ws, od, oi,
                         (cudaStream_t)stream);
}

// q_pad [n_rows, d], qbuf [B, S] int32, cands [B, C, d], ids [B, C] int32
// -> od [B, S, k] f32, oi [B, S, k] int32; G the group (0: the calculator's);
// ws holds the workspace's bytes (l2_topk_qbuf_workspace, same G). Returns a
// cudaError_t.
int l2_topk_qbuf_f32(const void* q_pad, int n_rows, const void* qbuf, int B, int S,
                     const void* cands, const void* ids, int C, int d, int k, int G, void* ws,
                     void* od, void* oi, void* stream) {
  return launch<float>(q_pad, n_rows, qbuf, B, S, cands, ids, C, d, k, G, ws, od, oi, stream);
}

int l2_topk_qbuf_bf16(const void* q_pad, int n_rows, const void* qbuf, int B, int S,
                      const void* cands, const void* ids, int C, int d, int k, int G, void* ws,
                      void* od, void* oi, void* stream) {
  return launch<__nv_bfloat16>(q_pad, n_rows, qbuf, B, S, cands, ids, C, d, k, G, ws, od, oi,
                               stream);
}

}  // extern "C"
