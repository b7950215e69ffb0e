// Flat and batched ADC scans with a running top-k, for sm_90a.
//
// Replaces the TPU kernels `pq_adc_topk` and `pq_adc_topk_batched`
// (repro/kernels/pq_adc.py, `_pq_adc_topk_kernel`,
// `_pq_adc_topk_batched_kernel`): for every query row q of bucket b,
//
//   d[n] = sum_m lut[b, q, m, codes[b, n, m]] + q_off[b, q] + cand_off[b, n]
//
// (an offset given as NULL adds nothing), and the k smallest (d, n) over the
// candidates with ids[b, n] >= 0, ascending as (dist, ids[b, n]), inf / -1
// past the valid ones. The flat form is one bucket. The sum runs over m in
// order, then q_off, then cand_off, with additions only, so the result
// equals the plain version bit for bit; an earlier candidate wins an exact
// tie.
//
// What bounds it on an H100: for the flat scan of 1,000 queries over 1M
// codes, its Q·N·m gathers from shared memory (1.91 ms at 32 words a clock
// an SM) and the m - 1 additions beside each candidate's; reading the LUTs
// and codes is ~32 MB. For the batched scan at the serve path's widths,
// bytes: the [B, Q, m, ks] LUTs (2.15 GB) and the [B, Q, k] outputs.
//
// The two forms have two bodies:
//  * the flat scan is adc_tile.cuh's: a block stages R query rows' LUTs in
//    slabs of four rows at a padded stride and takes one range of the
//    candidates; the lanes of a gather share a candidate and differ in
//    slab, so they meet fewer bank conflicts, and the block keeps one list
//    of each row's k smallest keys, filtered against the row's bound in
//    registers. At its end the block folds its lists into each row's list
//    in device memory, which lowers the row's bound to the k-th key over
//    every range finished so far; blocks run row group fastest, so a row's
//    later ranges start from a tight bound. The last block of a row group
//    writes the rows' ids from those lists;
//  * the batched scan is adc_scan.cuh's, as in the dispatch-buffer scan,
//    with an identity row map that marks no row empty: a block takes G query
//    rows (row b*Q + q: every row is scanned, the last one included), one
//    warp each, and one range of its bucket's candidates; its rows each see
//    their bucket's ~1,000 candidates against k = 400, most of which enter,
//    so it is bound by its selection, not its gathers. The row groups of one
//    bucket are the fastest grid index, so blocks in flight together read
//    the same codes from L2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_scan.cuh"
#include "adc_tile.cuh"

namespace {

using namespace adcscan;

constexpr int kFlatT = 4;  // consecutive candidates a lane of the flat scan takes

template <typename CT, int NV>
__global__ void __launch_bounds__(32 * kMaxGroup)
pq_adc_topk_scan_kernel(const float* __restrict__ lut, int Q, int m, int ks,
                        const CT* __restrict__ codes, const int* __restrict__ ids,
                        const float* __restrict__ cand_off, const float* __restrict__ q_off,
                        int N, int k, float* __restrict__ od, int* __restrict__ oi) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = blockDim.x / 32;
  const int s0 = blockIdx.x * G, b = blockIdx.y;
  const size_t row0 = (size_t)b * Q + s0;
  scan_group<CT, NV>(smem, lut, m, ks, nullptr, row0, min(G, Q - s0), 0x7fffffff,
                      q_off ? q_off + row0 : nullptr, codes + (size_t)b * N * m,
                      ids + (size_t)b * N, cand_off ? cand_off + (size_t)b * N : nullptr, 0, N,
                      k, od + row0 * k, oi + row0 * k);
}

// The flat scan's state in device memory (flat_scratch_bytes, laid out by
// FlatState): each row's bound thr [Q] (all bits set on entry), its list
// over the ranges finished so far, glist [Q, k] with its length glen [Q]
// and a lock glock [Q], and the finished ranges of each row group, gdone
// [groups] (all 0 on entry).
struct FlatState {
  unsigned long long* thr;
  unsigned long long* glist;
  int* glen;
  int* glock;
  int* gdone;

  __host__ __device__ FlatState(void* base, int Q, int k) {
    unsigned char* p = static_cast<unsigned char*>(base);
    thr = reinterpret_cast<unsigned long long*>(p);
    glist = reinterpret_cast<unsigned long long*>(p + adctile::align16((size_t)Q * 8));
    glen = reinterpret_cast<int*>(p + adctile::align16((size_t)Q * 8) +
                                  adctile::align16((size_t)Q * k * 8));
    glock = glen + Q;
    gdone = glock + Q;
  }
};

inline size_t flat_scratch_bytes(int Q, int k) {
  return adctile::align16((size_t)Q * 8) + adctile::align16((size_t)Q * k * 8) + (size_t)Q * 12;
}

// The flat scan: block i takes row group i % groups (R rows) and candidate
// range i / groups, so the first range of every row runs first and the
// later ones start from the bound the earlier ones leave. At its end a
// block folds each row's list into the row's list in device memory (so the
// row's bound becomes the k-th key over every range finished so far); the
// last block of a row group writes od / oi [Q, k] from those lists.
template <typename CT, int NV, int V>
__global__ void __launch_bounds__(32 * adctile::kMaxWarps)
pq_adc_topk_flat_kernel(const float* __restrict__ lut, int Q, int m, int ks,
                        const CT* __restrict__ codes, const int* __restrict__ ids,
                        const float* __restrict__ cand_off, const float* __restrict__ q_off,
                        int N, int k, int lgR, int splits, FlatState fs,
                        float* __restrict__ od, int* __restrict__ oi) {
  constexpr int T = kFlatT;
  using VT = typename adctile::Vec<V>::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = 1 << lgR, lgn = lgR - (V == 4 ? 2 : V == 2 ? 1 : 0);  // R / V slabs
  const int groups = (Q + R - 1) >> lgR;
  const int split = blockIdx.x / groups, grp = blockIdx.x % groups;
  const int q0 = grp * R;
  const int nr = min(R, Q - q0);
  const int S = adctile::slab_stride(m, ks, R, V);
  float* st = reinterpret_cast<float*>(smem);
  adctile::stage_rows(st, lut, q0, nr, m * ks, S, V);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W = blockDim.x >> 5;
  const int s = lane & ((1 << lgn) - 1), g = lane >> lgn;  // slab, candidate group
  unsigned char* rows = smem + adctile::stage_bytes(R, V, m, ks);
  adctile::RowsSelector sel;
  sel.init(rows, rows + adctile::block_bytes(R, k) + (size_t)warp * adctile::warp_bytes(), k, R);
  sel.init_rows();
  __syncthreads();

  unsigned long long* thr = fs.thr;
  float qo[V];
#pragma unroll
  for (int i = 0; i < V; ++i)
    qo[i] = q_off && s * V + i < nr ? __ldg(q_off + q0 + s * V + i) : 0.f;
  auto done = [=](int rr, uint64_t top) {  // row rr's list is full: lower its bound
    if (lane == 0) atomicMin(thr + q0 + rr, (unsigned long long)top);
  };
  int lo, hi;
  adctile::range_of(N, split, splits, lo, hi);
  bool in[T];
  float co[T];
  uint64_t lim[V];  // the bound of each of this lane's rows (kNone past the group)
  adctile::scan<CT, NV, V, T>(
      reinterpret_cast<const VT*>(st + (size_t)s * S), m, ks, codes, lo, hi, g,
      (32 >> lgn) * T, warp, W,
      [&](int c) {
#pragma unroll
        for (int i = 0; i < V; ++i)
          lim[i] = s * V + i < nr ? __ldcg(thr + q0 + s * V + i) : topksel::kNone;
#pragma unroll
        for (int t = 0; t < T; ++t) {
          in[t] = c + t < hi && __ldg(ids + c + t) >= 0;
          co[t] = cand_off && in[t] ? __ldg(cand_off + c + t) : 0.f;
        }
      },
      [&](int c, const VT (&acc)[T]) {
        float d[T * V];    // distance b = t·V + i: candidate c + t, row s·V + i
        unsigned may = 0;  // the distances that may pass: offered one a lane at a time
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float bound = topksel::key_dist(lim[i]);  // NaN while unbounded
#pragma unroll
          for (int t = 0; t < T; ++t) {
            float x = adctile::part(acc[t], i);
            if (q_off) x += qo[i];
            if (cand_off) x += co[t];
            d[t * V + i] = x;
            if (in[t] && s * V + i < nr && !(x > bound)) may |= 1u << (t * V + i);
          }
        }
        while (__any_sync(adctile::kAllLanes, may != 0)) {
          const int b = may ? __ffs(may) - 1 : 0, i = b % V;
          float x = d[0];
#pragma unroll
          for (int u = 1; u < T * V; ++u) x = b == u ? d[u] : x;
          uint64_t li = lim[0];
#pragma unroll
          for (int u = 1; u < V; ++u) li = i == u ? lim[u] : li;
          sel.offer(may != 0, topksel::pack(x, c + b / V), s * V + i, li, lane, done);
          may &= may - 1;
        }
      });
  sel.flush(lane, done);
  __syncthreads();

  // warp w folds rows w, w + W, ... into their lists in device memory (a
  // kBuf of the device list at a time through its scratch, under the row's
  // lock) and lowers their bounds
  for (int rr = warp; rr < nr; rr += W) {
    const int q = q0 + rr;
    uint64_t* list = sel.list(rr);
    unsigned long long* gl = fs.glist + (size_t)q * k;
    if (lane == 0)
      while (atomicCAS(fs.glock + q, 0, 1) != 0) {
      }
    __syncwarp();
    __threadfence();
    int len = sel.lens[rr];
    const int gn = __ldcg(fs.glen + q);
    for (int h = 0; h < gn; h += topksel::kBuf) {
      const int nb = min(topksel::kBuf, gn - h);
      for (int i = lane; i < nb; i += 32) sel.scratch[i] = __ldcg(gl + h + i);
      len = topksel::merge_buffer(list, sel.scratch, k, len, nb, lane);
    }
    for (int i = lane; i < len; i += 32) __stcg(gl + i, (unsigned long long)list[i]);
    __threadfence();
    __syncwarp();
    if (lane == 0) {
      __stcg(fs.glen + q, len);
      if (len == k) atomicMin(thr + q, (unsigned long long)list[k - 1]);
      __threadfence();
      atomicExch(fs.glock + q, 0);
    }
    __syncwarp();
  }

  // the last block of the row group writes its rows: each key's distance
  // and id (-1 beside a distance that is not finite), inf / -1 past a list
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    sel.locks[0] = atomicAdd(fs.gdone + grp, 1) == splits - 1;
  }
  __syncthreads();
  if (!sel.locks[0]) return;
  __threadfence();
  for (int rr = warp; rr < nr; rr += W) {
    const int q = q0 + rr;
    const int gn = __ldcg(fs.glen + q);
    for (int i = lane; i < k; i += 32) {
      float dist = CUDART_INF_F;
      int id = -1;
      if (i < gn) {
        const uint64_t key = __ldcg(fs.glist + (size_t)q * k + i);
        dist = topksel::key_dist(key);
        id = isfinite(dist) ? __ldg(ids + topksel::key_pos(key)) : -1;
      }
      od[(size_t)q * k + i] = dist;
      oi[(size_t)q * k + i] = id;
    }
  }
}

template <typename CT>
using FlatKernel = void (*)(const float*, int, int, int, const CT*, const int*, const float*,
                            const float*, int, int, int, int, FlatState, float*, int*);

template <typename CT, int NV>
FlatKernel<CT> flat_kernel_for(int R) {
  return R >= 4 ? pq_adc_topk_flat_kernel<CT, NV, 4>
                : R == 2 ? pq_adc_topk_flat_kernel<CT, NV, 2> : pq_adc_topk_flat_kernel<CT, NV, 1>;
}

template <typename CT>
adctile::Plan flat_plan_for(int nv, int m, int ks, int k) {
  auto smem = [=](int R, int W) {
    return adctile::topk_smem(R, adctile::slab_rows(R), W, m, ks, k);
  };
  return nv ? adctile::plan(flat_kernel_for<CT, 1>, smem)
            : adctile::plan(flat_kernel_for<CT, 0>, smem);
}

adctile::Plan flat_plan_for(int code_size, int nv, int m, int ks, int k) {
  return code_size == 2 ? flat_plan_for<uint16_t>(nv, m, ks, k)
                        : flat_plan_for<uint8_t>(nv, m, ks, k);
}

// The flat scan's candidate ranges.
int flat_splits(const adctile::Plan& p, int Q, int N) {
  if (p.lgR < 0) return 1;
  return adctile::splits_for(p, (Q + (1 << p.lgR) - 1) >> p.lgR, N, adctile::kMaxSplits);
}

template <typename CT>
int launch_flat(const void* lut, int Q, int m, int ks, const void* codes, const void* ids,
                const void* cand_off, const void* q_off, int N, int k, void* scratch, void* od,
                void* oi, void* stream) {
  const int nv = code_vectors(codes, m, sizeof(CT));
  const adctile::Plan p = flat_plan_for<CT>(nv, m, ks, k);
  if (p.lgR < 0) return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  const int splits = flat_splits(p, Q, N);
  cudaStream_t st = (cudaStream_t)stream;
  const FlatState fs(scratch, Q, k);
  cudaError_t err = cudaMemsetAsync(fs.thr, 0xff, (size_t)Q * 8, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(fs.glen, 0, (size_t)Q * 12, st);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)((Q + (1 << p.lgR) - 1) >> p.lgR) * splits;
  const FlatKernel<CT> kernel = nv ? flat_kernel_for<CT, 1>(1 << p.lgR)
                                   : flat_kernel_for<CT, 0>(1 << p.lgR);
  kernel<<<(unsigned)blocks, 32 * p.warps, p.smem, st>>>(
      (const float*)lut, Q, m, ks, (const CT*)codes, (const int*)ids, (const float*)cand_off,
      (const float*)q_off, N, k, p.lgR, splits, fs, (float*)od, (int*)oi);
  return (int)cudaGetLastError();
}

// The launch plan of the scan kernel that codes of this width take.
template <typename CT>
Plan plan_for(int nv, int m, int ks, int k) {
  return nv ? plan(pq_adc_topk_scan_kernel<CT, 1>, m, ks, k) : plan(pq_adc_topk_scan_kernel<CT, 0>, m, ks, k);
}

Plan plan_for(int code_size, int m, int ks, int k) {
  const int nv = code_vectors(m, code_size);
  return code_size == 2 ? plan_for<uint16_t>(nv, m, ks, k) : plan_for<uint8_t>(nv, m, ks, k);
}

template <typename CT>
int launch(const void* lut, int B, int Q, int m, int ks, const void* codes, const void* ids,
           const void* cand_off, const void* q_off, int N, int k, void* od, void* oi,
           void* stream) {
  const int nv = code_vectors(codes, m, sizeof(CT));
  const Plan p = plan_for<CT>(nv, m, ks, k);
  if (p.G == 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Q == 0) return 0;
  auto kernel = nv ? pq_adc_topk_scan_kernel<CT, 1> : pq_adc_topk_scan_kernel<CT, 0>;
  kernel<<<dim3((Q + p.G - 1) / p.G, B), 32 * p.G, p.smem, (cudaStream_t)stream>>>(
      (const float*)lut, Q, m, ks, (const CT*)codes, (const int*)ids, (const float*)cand_off,
      (const float*)q_off, N, k, (float*)od, (int*)oi);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one scan block needs at these widths, in bytes (one row's
// when none fits); above 232448 the launch is refused.
long long pq_adc_topk_smem_bytes(int m, int ks, int k, int code_size) {
  const int G = plan_for(code_size, m, ks, k).G;
  return (long long)smem_bytes(G > 0 ? G : 1, m, ks, k);
}

// The flat scan's launch at these widths on the current device, for codes
// whose base is 16-byte aligned: out = {rows a block R (0 when not even one
// row's LUT and list fit; refused), warps a block, candidate ranges, blocks
// an SM, shared memory a block in bytes (one row and one warp's when none
// fits)}. Returns a cudaError_t.
int pq_adc_topk_flat_plan(int Q, int N, int m, int ks, int k, int code_size, long long* out) {
  const adctile::Plan p = flat_plan_for(code_size, code_vectors(m, code_size), m, ks, k);
  out[0] = p.lgR < 0 ? 0 : 1 << p.lgR;
  out[1] = p.warps;
  out[2] = flat_splits(p, Q, N);
  out[3] = p.per_sm;
  out[4] = (long long)(p.lgR < 0 ? adctile::topk_smem(1, 1, 1, m, ks, k) : p.smem);
  return (int)cudaGetLastError();
}

// Bytes of the flat scan's scratch for Q query rows at k.
long long pq_adc_topk_flat_scratch_bytes(int Q, int k) {
  return (long long)flat_scratch_bytes(Q, k);
}

// The flat scan: lut [Q, m, ks] f32, codes [N, m] uint8 or uint16, ids [N]
// int32, cand_off [N] f32 or NULL, q_off [Q] f32 or NULL -> od [Q, k] f32,
// oi [Q, k] int32, in the candidate ranges pq_adc_topk_flat_plan reports
// for the codes' alignment; scratch holds pq_adc_topk_flat_scratch_bytes(Q,
// k) bytes, 16-byte aligned. Returns a cudaError_t.
int pq_adc_topk_flat_u8(const void* lut, int Q, int m, int ks, const void* codes,
                        const void* ids, const void* cand_off, const void* q_off, int N, int k,
                        void* scratch, void* od, void* oi, void* stream) {
  return launch_flat<uint8_t>(lut, Q, m, ks, codes, ids, cand_off, q_off, N, k, scratch, od, oi,
                              stream);
}

int pq_adc_topk_flat_u16(const void* lut, int Q, int m, int ks, const void* codes,
                         const void* ids, const void* cand_off, const void* q_off, int N, int k,
                         void* scratch, void* od, void* oi, void* stream) {
  return launch_flat<uint16_t>(lut, Q, m, ks, codes, ids, cand_off, q_off, N, k, scratch, od,
                               oi, stream);
}

// lut [B, Q, m, ks] f32, codes [B, N, m] uint8 or uint16, ids [B, N] int32,
// cand_off [B, N] f32 or NULL, q_off [B, Q] f32 or NULL -> od [B, Q, k] f32,
// oi [B, Q, k] int32. Returns a cudaError_t.
int pq_adc_topk_u8(const void* lut, int B, int Q, int m, int ks, const void* codes,
                   const void* ids, const void* cand_off, const void* q_off, int N, int k,
                   void* od, void* oi, void* stream) {
  return launch<uint8_t>(lut, B, Q, m, ks, codes, ids, cand_off, q_off, N, k, od, oi, stream);
}

int pq_adc_topk_u16(const void* lut, int B, int Q, int m, int ks, const void* codes,
                    const void* ids, const void* cand_off, const void* q_off, int N, int k,
                    void* od, void* oi, void* stream) {
  return launch<uint16_t>(lut, B, Q, m, ks, codes, ids, cand_off, q_off, N, k, od, oi, stream);
}

}  // extern "C"
