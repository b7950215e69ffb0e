// Dispatch-buffer L2 scan with a running top-k over byte rows, for sm_90a:
// the u8 tier's scan (serving/tiers.py), which no TPU kernel has a twin of.
//
// For each bucket b (one local partition): the query rows q_pad[qbuf[b, s]]
// of its occupied dispatch slots, uint8, against the partition's uint8
// candidates, with the exact integer distance
//
//   ||q||^2 - 2 q.x + ||x||^2
//
// where q.x is summed in int32 on the tensor cores (mma.sync m16n8k32,
// u8 x u8 -> s32), ||x||^2 is the store's int32 plane `sqnorm` and ||q||^2
// is summed here with dp4a. Every term is an integer below 2^24 while d <=
// 256 (255^2 * 256 < 2^24), so the distance is written out as an f32 that
// equals the integer sum of (q - x)^2 to the bit, and the merge after the
// scan (dedup_topk) takes it as it takes the f32 tier's. Candidates with id
// < 0 are masked; keys are (dist, position in the set), so an earlier
// candidate wins an exact tie, as in l2_topk_qbuf and the plain version.
//
// The work plan is l2_topk_qbuf's (qbuf_plan.cuh): a count kernel writes the
// empty slots' rows and counts each bucket's occupied slots and valid end, a
// plan kernel cuts the occupied slots into groups of G and a heavy group
// into candidate ranges, and a persistent scan kernel takes the items; the
// block that finishes a split group's last range merges its lists. What
// differs is a group's scan:
//  * a block of 8 warps takes G = 16 query rows, one m-tile of the MMA.
//    Their bytes sit in shared memory in the order of the MMA's A fragment,
//    so a lane reads its fragment of a k-step as one 16-byte load. The
//    k-axis is permuted, for the A and the B fragments alike: of each 64
//    bytes of a row, lane t of a quad takes bytes [16 t, 16 t + 16), the
//    words of two k-steps, so a candidate's fragments of two k-steps are one
//    16-byte load straight from device memory, and a quad reads 64
//    contiguous bytes;
//  * candidates go in tiles of 256, 32 a warp (four n-tiles of 8); a tile
//    with no valid id is skipped whole, and the range ends at its last
//    valid id, so padding costs nothing;
//  * the distances go through a shared tile to the warp that owns each row
//    and through the bulk selection of topk_select.cuh, as in l2_scan.cuh.
// What bounds it on an H100: its bytes (each probed partition's rows read
// once at d + 4 bytes, each list written once); the products are 2 d
// integer operations a (row, candidate) pair at the tensor cores' INT8
// rate. Widths are multiples of 64 up to 256; others are refused.

#include <cuda_runtime.h>
#include <stdint.h>

#include "qbuf_plan.cuh"
#include "topk_merge.cuh"
#include "topk_select.cuh"

namespace {

using namespace qbufplan;
using topksel::kAllLanes;
using topksel::Selector;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kG = 16;               // query rows a group: the MMA's M
constexpr int kRowsPerWarp = kG / kWarps;
constexpr int kTileC = 256;          // candidates a tile: 32 a warp, four n-tiles of 8
constexpr int kDistLd = kTileC + 8;  // the distance tile's stride
constexpr int kChunk = 64;           // two k-steps of the MMA: a 16-byte load a lane
constexpr int kMaxD = 256;           // 255^2 * 256 < 2^24: the distances stay exact in f32
constexpr int kChunksAtOnce = 2;     // chunks whose candidate bytes are loaded together
static_assert(kRangeUnit % kTileC == 0, "a range unit is whole tiles");

// Byte offsets of a block's shared memory.
struct Layout {
  size_t outs, rows, qsq, qf, cid, dt, sel, total;
  __host__ __device__ Layout(int d, int k) {
    size_t o = 16;  // the work item, and whether the block merges
    outs = o;  o += align16(kG * 4);
    rows = o;  o += align16(kG * 4);
    qsq = o;   o += align16(kG * 4);
    qf = o;    o += align16((size_t)kG * d);  // the rows' bytes in fragment order
    cid = o;   o += align16(kTileC * 4);
    dt = o;    o += align16((size_t)kG * kDistLd * 4);
    sel = o;   o += (size_t)kG * topksel::row_bytes(k);
    total = o;
  }
};

// A work item as the plan wrote it.
struct Item {
  int b, s_lo, nq, c_lo, c_hi, R, list0, range;
};

// The next item for the block (every thread calls this; `head` is an int of
// shared memory); false when none is left, for the whole block together.
__device__ __forceinline__ bool take_item(int* head, int* __restrict__ ctr,
                                          const int* __restrict__ items, long long item_cap,
                                          int n_front, int n_items, Item& it) {
  if (threadIdx.x == 0) *head = atomicAdd(ctr + kNext, 1);
  __syncthreads();  // also: the last item's reads of shared memory are done
  const int t = *head;
  if (t >= n_items) return false;
  const int4* p = reinterpret_cast<const int4*>(
      items + (t < n_front ? t : item_cap - 1 - (t - n_front)) * kItemInts);
  const int4 a = __ldg(p), z = __ldg(p + 1);
  it = Item{a.x, a.y, a.z, a.w, z.x, z.y, z.z, z.w};
  return true;
}

// Warp 0 alone: the group's slots, the occupied slots s_lo, ..., s_lo +
// nq - 1 of the bucket's qbuf row qb, into outs (the slot) and rows (its
// query row).
__device__ __forceinline__ void group_slots(const int* __restrict__ qb, int S, int empty_row,
                                            int s_lo, int nq, int* outs, int* rows, int lane) {
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

// After a split range's lists are written: whether this block finished the
// group's last range and so merges it (every thread calls this; `head` is an
// int of shared memory).
__device__ __forceinline__ bool last_range(int* head, int* __restrict__ arrive, int list0,
                                           int R) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *head = atomicAdd(arrive + list0, 1) == R - 1;
  __syncthreads();
  if (!*head) return false;
  __threadfence();
  return true;
}

// Merge a split group's partial lists, R a row, into its rows' outputs
// od / oi + outs[i] * k (the bucket's), the ids from ib; row i's selection
// lives at sel + i * row_bytes(k). Every thread of the block calls this; a
// warp takes rows warp, warp + warps, .... Out of line, so the scan's loop
// keeps its registers.
__device__ __noinline__ void merge_group(unsigned char* sel_mem, const int* outs, int k, int nq,
                                         int R, int list0, const float* __restrict__ pd,
                                         const int* __restrict__ pc,
                                         const int* __restrict__ ib, float* __restrict__ od,
                                         int* __restrict__ oi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int i = warp; i < nq; i += warps) {
    topksel::Selector sel;
    sel.init(sel_mem + (size_t)i * topksel::row_bytes(k), k);
    for (int r = 0; r < R; ++r) {
      const size_t list = ((size_t)list0 + (size_t)r * nq + i) * k;
      topkmerge::offer_list(sel, pd + list, pc + list, k, lane);
    }
    sel.flush(lane);
    sel.store(od + (size_t)outs[i] * k, oi + (size_t)outs[i] * k, ib, lane);
  }
}

// acc += a . b over one k-step: rows g and g + 8 (a.x / a.z and a.y / a.w,
// the k-step's low and high words), column g of b (b.x / b.y).
__device__ __forceinline__ void mma_u8(int (&acc)[4], const uint4& a, const uint2& b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

// Scan candidates [c_lo, c_end) of one set (rows cb [*, d], norms sqn, ids
// ib) for the group's nq rows (1 <= nq <= kG; query rows rows[i], written by
// the caller) and write row i's list to od / oi [(outs[i] or out0 + i) * k,
// + k): the id ib[position] (or the position itself when write_ids is
// false, for the merge); inf / -1 past a list's length. Every thread of the
// block calls this.
__device__ void scan_group(unsigned char* smem, const uint8_t* __restrict__ q, int nq, int d,
                           const uint8_t* __restrict__ cb, const int* __restrict__ sqn,
                           const int* __restrict__ ib, int c_lo, int c_end, int k,
                           float* __restrict__ od, int* __restrict__ oi, bool outs_given,
                           size_t out0, bool write_ids) {
  const Layout lay(d, k);
  const int* outs = reinterpret_cast<const int*>(smem + lay.outs);
  const int* rows = reinterpret_cast<const int*>(smem + lay.rows);
  int* qsq = reinterpret_cast<int*>(smem + lay.qsq);
  uint32_t* qf = reinterpret_cast<uint32_t*>(smem + lay.qf);
  int* cid = reinterpret_cast<int*>(smem + lay.cid);
  float* dt = reinterpret_cast<float*>(smem + lay.dt);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ks = d / 32, chunks = d / kChunk;  // k-steps; 64-byte chunks of a row
  __syncthreads();  // rows / outs written by the caller

  // the rows' words in fragment order: word (s 32 + lane) 4 + reg holds,
  // for k-step s = 2 c + h, the lane's quad place t and group g, bytes
  // 64 c + 16 t + 8 h (reg 0, 1) or + 4 (reg 2, 3) of row g (reg 0, 2) or
  // g + 8 (reg 1, 3); zero past nq
  for (int w = tid; w < kG * d / 4; w += kThreads) {
    const int i = w / (d / 4), byte = 4 * (w % (d / 4));
    const int in = byte % kChunk, tq = in / 16, word = (in % 16) / 4;
    const int s = 2 * (byte / kChunk) + (word >> 1), reg = 2 * (word & 1) + (i >> 3);
    const uint32_t v =
        i < nq ? __ldg(reinterpret_cast<const uint32_t*>(q + (size_t)rows[i] * d + byte)) : 0u;
    qf[(s * 32 + (i & 7) * 4 + tq) * 4 + reg] = v;
  }
  if (tid < kG) {  // ||q||^2, exactly
    unsigned acc = 0;
    if (tid < nq) {
      const uint32_t* row = reinterpret_cast<const uint32_t*>(q + (size_t)rows[tid] * d);
      for (int j = 0; j < d / 4; ++j) {
        const uint32_t v = __ldg(row + j);
        acc = __dp4a(v, v, acc);
      }
    }
    qsq[tid] = (int)acc;
  }

  Selector sel[kRowsPerWarp];
#pragma unroll
  for (int m = 0; m < kRowsPerWarp; ++m)
    sel[m].init(smem + lay.sel + (size_t)(warp + m * kWarps) * topksel::row_bytes(k), k);

  const uint4* qf4 = reinterpret_cast<const uint4*>(qf);
  int c0 = l2scan::seek_tile<kTileC>(cid, ib, c_lo, c_end);  // a barrier: qf, qsq are written
  while (c0 < c_end) {
    // this warp's candidates: c0 + 32 warp + 8 j + g, the lane's 16 bytes
    // of each of their chunks
    const uint8_t* src[4];
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cl = 32 * warp + 8 * j + g;
      ok[j] = c0 + cl < c_end && cid[cl] >= 0;
      src[j] = cb + (size_t)(c0 + cl) * d + 16 * t;
    }
    int acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] = 0;
    for (int c = 0; c < chunks; c += kChunksAtOnce) {
      uint4 bv[4][kChunksAtOnce];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int u = 0; u < kChunksAtOnce; ++u)
          bv[j][u] = ok[j] && c + u < chunks
                         ? __ldg(reinterpret_cast<const uint4*>(src[j] + kChunk * (c + u)))
                         : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
      for (int u = 0; u < kChunksAtOnce; ++u) {
        if (c + u >= chunks) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint4 a = qf4[(2 * (c + u) + h) * 32 + lane];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            mma_u8(acc[j], a, h ? make_uint2(bv[j][u].z, bv[j][u].w)
                                : make_uint2(bv[j][u].x, bv[j][u].y));
        }
      }
    }
    // the lane's distances: rows g and g + 8, candidates 32 warp + 8 j + 2 t (+ 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cl = 32 * warp + 8 * j + 2 * t;
      const int x0 = c0 + cl < c_end ? __ldg(sqn + c0 + cl) : 0;
      const int x1 = c0 + cl + 1 < c_end ? __ldg(sqn + c0 + cl + 1) : 0;
      const int r0 = g, r1 = g + 8;
      *reinterpret_cast<float2*>(dt + r0 * kDistLd + cl) =
          make_float2((float)(qsq[r0] - 2 * acc[j][0] + x0),
                      (float)(qsq[r0] - 2 * acc[j][1] + x1));
      *reinterpret_cast<float2*>(dt + r1 * kDistLd + cl) =
          make_float2((float)(qsq[r1] - 2 * acc[j][2] + x0),
                      (float)(qsq[r1] - 2 * acc[j][3] + x1));
    }
    __syncthreads();

    // each warp offers its rows' distances, 32 candidates at a time; a
    // distance above the k-th key's cannot enter (l2_scan.cuh)
#pragma unroll
    for (int m = 0; m < kRowsPerWarp; ++m) {
      const int r = warp + m * kWarps;
      if (r >= nq) break;
      const float kd = topksel::key_dist(sel[m].kth);
      for (int h = 0; h < kTileC; h += 32) {
        const int cl = h + lane;
        const float dist = dt[r * kDistLd + cl];
        const bool valid = cid[cl] >= 0;
        if (__any_sync(kAllLanes, valid && !(dist > kd)))
          sel[m].offer(valid, topksel::pack(dist, c0 + cl), lane);
      }
    }
    __syncthreads();  // the tile's ids and distances are read
    c0 = l2scan::seek_tile<kTileC>(cid, ib, c0 + kTileC, c_end);
  }

#pragma unroll
  for (int m = 0; m < kRowsPerWarp; ++m) {
    const int r = warp + m * kWarps;
    if (r >= nq) break;
    sel[m].flush(lane);
    const size_t o = (outs_given ? (size_t)outs[r] : out0 + r) * k;
    sel[m].store(od + o, oi + o, write_ids ? ib : nullptr, lane);
  }
}

__global__ void __launch_bounds__(kCountThreads)
l2u8_topk_qbuf_count_kernel(const int* __restrict__ qbuf, int n_rows, int S,
                            const int* __restrict__ ids, int C, int k, float* __restrict__ od,
                            int* __restrict__ oi, int* __restrict__ ctr, int* __restrict__ occ,
                            int* __restrict__ end) {
  count_bucket(qbuf, n_rows, S, ids, C, k, od, oi, ctr, occ, end);
}

__global__ void __launch_bounds__(kPlanThreads)
l2u8_topk_qbuf_plan_kernel(int B, int G, int blocks, long long pool_lists, long long item_cap,
                           const int* __restrict__ occ, const int* __restrict__ end,
                           int* __restrict__ ctr, int* __restrict__ items) {
  plan_bucket(B, G, blocks, pool_lists, item_cap, occ, end, ctr, items);
}

// As many blocks as the card holds at once, each taking work items until
// the list is done.
__global__ void __launch_bounds__(kThreads)
l2u8_topk_qbuf_kernel(const uint8_t* __restrict__ q_pad, int n_rows,
                      const int* __restrict__ qbuf, int S, const uint8_t* __restrict__ cands,
                      const int* __restrict__ sqnorm, const int* __restrict__ ids, int C, int d,
                      int k, long long item_cap, int* __restrict__ ctr,
                      const int* __restrict__ items, float* __restrict__ od,
                      int* __restrict__ oi, float* __restrict__ pd, int* __restrict__ pc) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(d, k);
  int* head = reinterpret_cast<int*>(smem);
  int* outs = reinterpret_cast<int*>(smem + lay.outs);
  int* rows = reinterpret_cast<int*>(smem + lay.rows);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_front = ctr[kFront], n_items = n_front + ctr[kBack];
  Item it;
  while (take_item(head, ctr, items, item_cap, n_front, n_items, it)) {
    const int b = it.b, nq = it.nq, R = it.R, list0 = it.list0;
    if (warp == 0) group_slots(qbuf + (size_t)b * S, S, n_rows - 1, it.s_lo, nq, outs, rows, lane);
    const int* ib = ids + (size_t)b * C;
    const size_t first = R > 1 ? (size_t)list0 + (size_t)it.range * nq : 0;
    scan_group(smem, q_pad, nq, d, cands + (size_t)b * C * d, sqnorm + (size_t)b * C, ib,
                  it.c_lo, it.c_hi, k, R > 1 ? pd : od + (size_t)b * S * k,
                  R > 1 ? pc : oi + (size_t)b * S * k, R == 1, first, R == 1);
    if (R == 1 || !last_range(head + 1, ctr + kCounterInts, list0, R)) continue;
    merge_group(smem + lay.sel, outs, k, nq, R, list0, pd, pc, ib, od + (size_t)b * S * k,
                oi + (size_t)b * S * k);
  }
}

// The launch at width d and depth k: a group of kG rows, the block's shared
// memory and the blocks an SM holds; G = 0 in the plan when the width is not
// taken or the block does not fit.
Plan plan_for(int d, int k) {
  Plan p;
  if (d <= 0 || d % kChunk || d > kMaxD || k < 1) return p;
  const size_t smem = Layout(d, k).total;
  int per_sm = 0;
  if (smem > scancommon::kMaxSmem ||
      cudaFuncSetAttribute(l2u8_topk_qbuf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)scancommon::kMaxSmem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, l2u8_topk_qbuf_kernel, kThreads,
                                                    smem) != cudaSuccess ||
      per_sm == 0)
    return p;
  return {kG, smem, per_sm};
}

}  // namespace

extern "C" {

// The workspace of a launch over B buckets of S slots, as
// l2_topk_qbuf_workspace reports it.
void l2u8_topk_qbuf_workspace(int B, int S, int d, int k, long long* out) {
  workspace_sizes(plan_for(d, k), B, S, k, out);
}

// q_pad [n_rows, d] uint8 (row n_rows - 1 for the empty slots), qbuf [B, S]
// int32, cands [B, C, d] uint8, sqnorm [B, C] int32 (||x||^2), ids [B, C]
// int32 -> od [B, S, k] f32, oi [B, S, k] int32; ws holds the workspace's
// bytes (l2u8_topk_qbuf_workspace). Returns a cudaError_t
// (cudaErrorInvalidValue for a width not taken).
int l2u8_topk_qbuf(const void* q_pad, int n_rows, const void* qbuf, int B, int S,
                   const void* cands, const void* sqnorm, const void* ids, int C, int d, int k,
                   void* ws, void* od, void* oi, void* stream) {
  const Plan p = plan_for(d, k);
  if (p.G == 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  int blocks = 0;
  cudaError_t err = scan_blocks(p, &blocks);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  err = plan_items(l2u8_topk_qbuf_count_kernel, l2u8_topk_qbuf_plan_kernel, p, blocks, qbuf,
                   n_rows, B, S, ids, C, k, ws, od, oi, st);
  if (err != cudaSuccess) return (int)err;
  const Workspace w(B, S, k, p.G, blocks);
  unsigned char* base = (unsigned char*)ws;
  l2u8_topk_qbuf_kernel<<<blocks, kThreads, p.smem, st>>>(
      (const uint8_t*)q_pad, n_rows, (const int*)qbuf, S, (const uint8_t*)cands,
      (const int*)sqnorm, (const int*)ids, C, d, k, w.item_cap, (int*)base,
      (const int*)(base + w.items), (float*)od, (int*)oi, (float*)(base + w.pd),
      (int*)(base + w.pc));
  return (int)cudaGetLastError();
}

}  // extern "C"
