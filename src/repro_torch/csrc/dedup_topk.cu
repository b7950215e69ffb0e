// Replica-aware merge: exact per-row top-k over distinct ids, for sm_90a.
//
// Replaces the TPU kernel `dedup_topk` (repro/kernels/dedup_topk.py,
// `_dedup_topk_kernel` + `_bitonic_sort_by_id_dist`). Per row of a candidate
// pool: drop invalid entries (id < 0 or a non-finite distance, as the oracle
// does), collapse duplicate ids to their smallest distance, and return the k
// best (dist, id) pairs ordered by (dist, id), padded with inf / -1.
//
// What bounds it on an H100: the row must be read once, Q*P*8 bytes (the
// serve step's pool is [q_row, b_loc*k]: 1024 x 102,400 entries, ~0.84 GB, at
// the main path). Only a few thousand entries per row are valid, so the
// arithmetic is small and the kernel is bound by the bytes it streams.
//
// What this simple design does about it: the TPU kernel sorts the whole row
// in VMEM, but a 102,400-entry row (~0.8 MB) cannot sit in shared memory, so
// one block per row streams the row in steps of 1,024 entries (4 independent
// coalesced loads per thread) and compacts the entries that matter into a
// 4,096-entry shared buffer that also holds the running list (at most k
// distinct ids). When the buffer is nearly full, and once at the end, it is
// merged: bitonic sort by (id, dist), drop every copy but each id's first,
// bitonic sort by (dist, id), keep k. Once the list is full, an entry whose
// (dist, id) key is not below the k-th key is skipped as it streams past.
// That is exact: the k-th key only ever falls, an id dropped earlier can come
// back only with a smaller distance, and then it competes afresh.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kStep = kThreads * kPerThread;  // entries streamed per step
constexpr int kBuf = 4096;                    // shared buffer (power of two)
constexpr int kSentinelId = INT_MAX;

__device__ __forceinline__ bool less_id_dist(int ia, float da, int ib, float db) {
  return ia < ib || (ia == ib && da < db);
}

__device__ __forceinline__ bool less_dist_id(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Ascending bitonic sort of the first n2 (a power of two) entries.
template <bool kByDist>
__device__ void bitonic_sort(float* bd, int* bi, int n2) {
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n2 / 2; t += kThreads) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const bool asc = (i & size) == 0;
        const float di = bd[i], dj = bd[j];
        const int ii = bi[i], ij = bi[j];
        const bool j_first = kByDist ? less_dist_id(dj, ij, di, ii)
                                     : less_id_dist(ij, dj, ii, di);
        if (j_first == asc) {
          bd[i] = dj; bd[j] = di;
          bi[i] = ij; bi[j] = ii;
        }
      }
      __syncthreads();
    }
  }
}

// Merge the n buffered entries into the running list; returns its length.
__device__ int merge(float* bd, int* bi, int n, int k, int* m_s) {
  int n2 = 2;
  while (n2 < n) n2 <<= 1;
  for (int i = n + threadIdx.x; i < n2; i += kThreads) {
    bd[i] = CUDART_INF_F;
    bi[i] = kSentinelId;
  }
  if (threadIdx.x == 0) *m_s = 0;
  __syncthreads();
  bitonic_sort<false>(bd, bi, n2);
  // every copy of an id but the first (its smallest distance) is dropped;
  // only distances are written, so reading the neighbour's id is race-free
  for (int i = 1 + threadIdx.x; i < n2; i += kThreads)
    if (bi[i] == bi[i - 1]) bd[i] = CUDART_INF_F;
  __syncthreads();
  bitonic_sort<true>(bd, bi, n2);
  // valid entries have finite distances and now come first: count them
  for (int i = threadIdx.x; i < n2; i += kThreads)
    if (bd[i] < CUDART_INF_F && (i + 1 == n2 || !(bd[i + 1] < CUDART_INF_F))) *m_s = i + 1;
  __syncthreads();
  const int m = *m_s;
  __syncthreads();
  return min(m, k);
}

__global__ void __launch_bounds__(kThreads)
dedup_topk_kernel(const float* __restrict__ dists, const int* __restrict__ ids,
                  int P, int k, float* __restrict__ od, int* __restrict__ oi) {
  __shared__ float bd[kBuf];
  __shared__ int bi[kBuf];
  __shared__ int cnt, len_s, m_s;
  __shared__ float thr_d;
  __shared__ int thr_i;

  const int tid = threadIdx.x;
  const float* dr = dists + (size_t)blockIdx.x * P;
  const int* ir = ids + (size_t)blockIdx.x * P;
  if (tid == 0) { cnt = 0; len_s = 0; thr_d = CUDART_INF_F; thr_i = kSentinelId; }
  __syncthreads();

  for (int base = 0; base < P; base += kStep) {
    const bool full = len_s == k;
    const float td = thr_d;
    const int ti = thr_i;
    float dv[kPerThread];
    int iv[kPerThread];
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const int e = base + u * kThreads + tid;
      iv[u] = -1;
      dv[u] = 0.f;
      if (e < P) { dv[u] = dr[e]; iv[u] = ir[e]; }
    }
#pragma unroll
    for (int u = 0; u < kPerThread; ++u) {
      const bool pass = iv[u] >= 0 && isfinite(dv[u]) &&
                        (!full || less_dist_id(dv[u], iv[u], td, ti));
      if (pass) {
        const int pos = atomicAdd(&cnt, 1);
        bd[pos] = dv[u];
        bi[pos] = iv[u];
      }
    }
    __syncthreads();
    const int n = cnt;
    __syncthreads();  // everyone has read cnt before anyone changes it
    if (n > kBuf - kStep) {
      const int len = merge(bd, bi, n, k, &m_s);
      if (tid == 0) {
        cnt = len;
        len_s = len;
        if (len == k) { thr_d = bd[k - 1]; thr_i = bi[k - 1]; }
      }
      __syncthreads();
    }
  }
  const int len = merge(bd, bi, cnt, k, &m_s);
  float* odr = od + (size_t)blockIdx.x * k;
  int* oir = oi + (size_t)blockIdx.x * k;
  for (int i = tid; i < k; i += kThreads) {
    odr[i] = i < len ? bd[i] : CUDART_INF_F;
    oir[i] = i < len ? bi[i] : -1;
  }
}

}  // namespace

extern "C" {

// Largest k the shared buffer supports.
int dedup_topk_max_k() { return kBuf - kStep; }

// dists [Q, P] f32, ids [Q, P] int32 -> od [Q, k] f32, oi [Q, k] int32.
// Returns a cudaError_t.
int dedup_topk(const void* dists, const void* ids, int Q, int P, int k,
               void* od, void* oi, void* stream) {
  if (k < 1 || k > kBuf - kStep) return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  dedup_topk_kernel<<<Q, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)dists, (const int*)ids, P, k, (float*)od, (int*)oi);
  return (int)cudaGetLastError();
}

}  // extern "C"
