// Replica-aware merge: exact per-row top-k over distinct ids, for sm_90a.
//
// Replaces the TPU kernel `dedup_topk` (repro/kernels/dedup_topk.py,
// `_dedup_topk_kernel` + `_bitonic_sort_by_id_dist`). Per row of a candidate
// pool: drop invalid entries (id < 0 or a non-finite distance, as the oracle
// does), collapse duplicate ids to their smallest distance, and return the k
// best (dist, id) pairs ordered by (dist, id), padded with inf / -1; and, if
// asked, the row's duplicate count: its entries with an id >= 0 less its
// distinct ids.
//
// What bounds it on an H100: the row must be read once, Q*P*8 bytes. The
// serve step hands it each query's dispatched top-k lists only, [q_row,
// nprobe_max*k] (8,192 x 6,400 entries, ~0.42 GB, at the main path), of
// which a seventh or so hold a candidate; the arithmetic is small.
//
// One design at every width. A block takes a row whole into a hash table of
// 64-bit slots, (distance, id), keyed by the id (open addressing, linear
// probing; at most three quarters full, whatever the ids): each entry with
// an id >= 0 goes in, a warp inserting 32 at a time; the first copy of an id
// claims a slot by a 32-bit compare-and-swap of its id word, and every copy
// lowers the distance word with an atomic min. The row's duplicate count
// falls out: the entries put in less the slots claimed. A slot read whole is
// the key (distance, id); each id whose distance is finite is packed to the
// table's front, and a radix select over those keys finds the k-th smallest a
// byte at a time, stopping at the first byte that separates the k best; each
// of those k is written at its rank among them (past 256 of them, they are
// sorted, bitonic). The work per row is a pass over the row, one over the
// table and a few over its ids, not a sort of the row.
//
// Where the table and the k best fit the block's shared memory (rows of up to
// ~19,000 entries at k = 100), it lives there, one block a row. A wider row's
// table lives in a global-memory workspace the caller allocates, one table a
// block, and each block takes rows in turn; the steps are the same.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowPerThread = 8;              // loads and packs a thread takes a step
constexpr int kRowStep = kThreads * kRowPerThread;
constexpr int kSmemMax = 200 * 1024;          // dynamic shared memory a block may take
constexpr int kGlobalBlocksPerSm = 2;         // blocks (and tables) of the global variant
constexpr unsigned long long kEmpty = ~0ull;  // sorts after every packed key
constexpr unsigned int kInfKey = 0xFF800000u; // order_key(+inf)

// A u32 whose unsigned order is the floats' order (-0 packs as +0, so the
// two tie as they compare); from_order_key undoes it.
__device__ __forceinline__ unsigned int order_key(float f) {
  const unsigned int u = __float_as_uint(f == 0.f ? 0.f : f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_key(unsigned int u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ __forceinline__ void order_pair(unsigned long long* keys, int i, int j) {
  const unsigned long long a = keys[i], b = keys[j];
  if (b < a) {
    keys[i] = b;
    keys[j] = a;
  }
}

// Ascending sort of keys[0, n): the bitonic network over the next power of
// two in the form whose first step of each merge compares mirrored
// positions, so that every comparator puts the smaller key at the lower
// position. A position past n then acts as +infinity: its comparators would
// leave the lower key where it is, and are skipped.
__device__ void sort_keys(unsigned long long* keys, int n) {
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int lh = 0; (2 << lh) <= n2; ++lh) {
    const int half = 1 << lh;
    for (int t = threadIdx.x; t < n2 / 2; t += kThreads) {
      const int base = (t >> lh) << (lh + 1);
      const int off = t & (half - 1);
      const int j = base + 2 * half - 1 - off;
      if (j < n) order_pair(keys, base + off, j);
    }
    __syncthreads();
    for (int stride = half >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < n2 / 2; t += kThreads) {
        const int i = 2 * t - (t & (stride - 1));
        if (i + stride < n) order_pair(keys, i, i + stride);
      }
      __syncthreads();
    }
  }
}

// Slots of a row's hash table: at least 4/3 of the row, so that it is at
// most three quarters full, in whole warps.
__host__ __device__ __forceinline__ long long table_slots(int P) {
  return (((long long)P + P / 3 + 1) + 31) / 32 * 32;
}

// Slots a block's table and its k best take: in shared memory where they fit,
// else in the workspace.
__host__ __forceinline__ long long block_slots(int P, int k) { return table_slots(P) + k; }

__host__ __forceinline__ bool fits_shared(int P, int k) {
  return block_slots(P, k) * (long long)sizeof(unsigned long long) <= kSmemMax;
}

// Blocks of the global variant: each keeps a table in the workspace.
__host__ int global_blocks(int Q) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return Q < kGlobalBlocksPerSm * sms ? Q : kGlobalBlocksPerSm * sms;
}

// Adds each thread's v into *total (a shared counter set to 0 beforehand).
__device__ __forceinline__ void block_add(int v, int* total) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0 && v) atomicAdd(total, v);
}

// Appends each thread's key for which take holds to out[*count ...], in any
// order (one atomic a warp). Every thread of the block calls it.
__device__ __forceinline__ void append(bool take, unsigned long long key,
                                       unsigned long long* out, int* count) {
  const int lane = threadIdx.x & 31;
  const unsigned int mask = __ballot_sync(0xffffffffu, take);
  int at = 0;
  if (lane == 0 && mask) at = atomicAdd(count, __popc(mask));
  at = __shfl_sync(0xffffffffu, at, 0);
  if (take) out[at + __popc(mask & ((1u << lane) - 1))] = key;
}

// A slot of the hash table: the id in the low word (-1 = free), the order
// key of its smallest distance in the high word, so that the slot read as
// one 64-bit word is the (distance, id) key.
constexpr unsigned long long kFreeSlot = ((unsigned long long)kInfKey << 32) | 0xFFFFFFFFull;

// Puts entry e (a slot's layout) into the table of T slots; adds 1 to
// distinct if its id claimed a slot.
__device__ __forceinline__ void insert(unsigned long long* table, unsigned int T,
                                       unsigned long long e, int& distinct) {
  int* slot_id = reinterpret_cast<int*>(table);
  unsigned int* slot_dist = reinterpret_cast<unsigned int*>(table);
  const int id = (int)(unsigned int)e;
  unsigned int h = __umulhi((unsigned int)id * 0x9E3779B1u, T);
  while (true) {
    const int cur = atomicCAS(&slot_id[2 * h], -1, id);
    if (cur == -1 || cur == id) {
      distinct += cur == -1;
      atomicMin(&slot_dist[2 * h + 1], (unsigned int)(e >> 32));
      return;
    }
    h = h + 1 == T ? 0 : h + 1;
  }
}

static_assert(kThreads == 256, "one thread a radix bin");

// kShared: the table in dynamic shared memory, one block a row; else in the
// workspace ws, table_slots(P) + k slots a block, each block taking rows in
// turn.
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
dedup_topk_kernel(const float* __restrict__ dists, const int* __restrict__ ids, int Q, int P,
                  int k, float* __restrict__ od, int* __restrict__ oi,
                  long long* __restrict__ dups, unsigned long long* ws) {
  extern __shared__ unsigned long long smem[];  // table_slots(P) slots, then k
  __shared__ unsigned long long stage[kThreads / 32][64];
  __shared__ int hist[2][256];
  __shared__ int n_s, distinct_s, m_s, sel_s, bin_s, before_s;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int T = (int)table_slots(P);
  unsigned long long* table = kShared ? smem : ws + (size_t)blockIdx.x * (T + k);
  unsigned long long* sel = table + T;

  for (int row = blockIdx.x; row < Q; row += gridDim.x) {
    const float* dr = dists + (size_t)row * P;
    const int* ir = ids + (size_t)row * P;
    for (int i = tid; i < T; i += kThreads) table[i] = kFreeSlot;
    if (tid == 0) { n_s = 0; distinct_s = 0; m_s = 0; sel_s = 0; }
    __syncthreads();

    // 1. every entry with an id >= 0 into the table, keyed by its id: the
    //    first copy of an id claims a slot, every copy lowers its distance. A
    //    non-finite distance goes in as +inf, so its id is still counted. A
    //    warp stages its entries and inserts them 32 at a time, every lane
    //    busy.
    unsigned long long* st = stage[tid >> 5];
    int staged = 0, n = 0, distinct = 0;
    for (int base = 0; base < P; base += kRowStep) {
      float dv[kRowPerThread];
      int iv[kRowPerThread];
#pragma unroll
      for (int u = 0; u < kRowPerThread; ++u) {
        const int e = base + u * kThreads + tid;
        iv[u] = -1;
        dv[u] = 0.f;
        if (e < P) { dv[u] = dr[e]; iv[u] = ir[e]; }
      }
#pragma unroll
      for (int u = 0; u < kRowPerThread; ++u) {
        const bool take = iv[u] >= 0;
        const unsigned int mask = __ballot_sync(0xffffffffu, take);
        if (take) {
          const unsigned int dk = isfinite(dv[u]) ? order_key(dv[u]) : kInfKey;
          st[staged + __popc(mask & ((1u << lane) - 1))] =
              ((unsigned long long)dk << 32) | (unsigned int)iv[u];
        }
        staged += __popc(mask);
        if (lane == 0) n += __popc(mask);
        __syncwarp();
        if (staged >= 32) {
          staged -= 32;
          insert(table, T, st[staged + lane], distinct);
          __syncwarp();
        }
      }
    }
    if (lane < staged) insert(table, T, st[lane], distinct);
    block_add(n, &n_s);
    block_add(distinct, &distinct_s);
    __syncthreads();

    // 2. each id whose distance is finite, its slot read as the key
    //    (distance, id), packed to the table's front in place: a chunk is
    //    read whole before any of it is written, and nothing lands past the
    //    chunk
    for (int base = 0; base < T; base += kRowStep) {
      unsigned long long kv[kRowPerThread];
#pragma unroll
      for (int u = 0; u < kRowPerThread; ++u) {
        const int i = base + u * kThreads + tid;
        kv[u] = i < T ? table[i] : kFreeSlot;
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < kRowPerThread; ++u)
        append((int)(unsigned int)kv[u] >= 0 && (unsigned int)(kv[u] >> 32) != kInfKey, kv[u],
               table, &m_s);
      __syncthreads();
    }
    const int m = m_s;

    // 3. the k smallest keys. Past k, a radix select finds the k-th key a
    //    byte at a time from the top and stops at the first byte whose bin
    //    holds just the keys still wanted; those k are taken.
    unsigned long long* best = table;
    if (m > k) {
      unsigned long long prefix = 0;
      int want = k, shift = 64, buf = 0;
      hist[0][tid] = 0;
      __syncthreads();
      while (true) {
        shift -= 8;
        int* hb = hist[buf];
        // the keys that share the byte's prefix, counted a bin at a time per
        // warp (lanes outside the prefix take bins of their own, past 255):
        // a distance's top bytes are alike across a row, so plain atomics
        // would queue on one bin
        const unsigned long long above = shift == 56 ? 0ull : ~0ull << (shift + 8);
        for (int base = 0; base < m; base += kThreads) {
          const int i = base + tid;
          const unsigned long long key = i < m ? table[i] : kEmpty;
          const bool in = i < m && ((key ^ prefix) & above) == 0;
          const int bin = in ? (int)((key >> shift) & 0xFF) : 256 + (tid & 31);
          const unsigned int peers = __match_any_sync(0xffffffffu, bin);
          if (in && (tid & 31) == __ffs(peers) - 1) atomicAdd(&hb[bin], __popc(peers));
        }
        __syncthreads();
        // warp 0 finds the bin where the count reaches want; the others clear
        // the next byte's histogram, which nobody reads now
        if (tid < 32) {
          int c[8], sum = 0;
#pragma unroll
          for (int j = 0; j < 8; ++j) { c[j] = hb[tid * 8 + j]; sum += c[j]; }
          int inc = sum;
#pragma unroll
          for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, inc, o);
            if (tid >= o) inc += v;
          }
          int acc = inc - sum;
          if (acc < want && want <= inc) {
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              if (acc < want && want <= acc + c[j]) { bin_s = tid * 8 + j; before_s = acc; }
              acc += c[j];
            }
          }
        } else {
          for (int j = tid - 32; j < 256; j += kThreads - 32) hist[buf ^ 1][j] = 0;
        }
        __syncthreads();
        // bin_s, before_s and this histogram are rewritten only after the
        // next byte's first barrier, which every thread meets after these
        // reads
        const int b = bin_s;
        want -= before_s;
        prefix |= (unsigned long long)b << shift;
        const bool done = hb[b] == want;
        buf ^= 1;
        if (done) break;
      }
      const unsigned long long top = prefix >> shift;
      for (int base = 0; base < m; base += kThreads) {
        const int i = base + tid;
        const unsigned long long key = i < m ? table[i] : kEmpty;
        append(i < m && (key >> shift) <= top, key, sel, &sel_s);
      }
      best = sel;
    }
    __syncthreads();

    // 4. the len best keys in order, then padding. Up to a key a thread,
    //    each key's place is its rank among them (the keys are distinct);
    //    more are sorted.
    float* odr = od + (size_t)row * k;
    int* oir = oi + (size_t)row * k;
    const int len = min(m, k);
    if (len <= kThreads) {
      if (tid < len) {
        const unsigned long long key = best[tid];
        int r = 0;
        for (int j = 0; j < len; ++j) r += best[j] < key;
        odr[r] = from_order_key((unsigned int)(key >> 32));
        oir[r] = (int)(unsigned int)key;
      }
    } else {
      sort_keys(best, len);
      for (int i = tid; i < len; i += kThreads) {
        odr[i] = from_order_key((unsigned int)(best[i] >> 32));
        oir[i] = (int)(unsigned int)best[i];
      }
    }
    for (int i = len + tid; i < k; i += kThreads) {
      odr[i] = CUDART_INF_F;
      oir[i] = -1;
    }
    if (dups != nullptr && tid == 0) dups[row] = n_s - distinct_s;
    __syncthreads();  // the next row clears the table and the counters
  }
}

}  // namespace

extern "C" {

// Slots (8 bytes each) of the global-memory workspace a call needs: 0 where
// a row's table fits in shared memory. Call it with the pool's device current.
long long dedup_topk_workspace(int Q, int P, int k) {
  if (Q <= 0 || k < 1 || fits_shared(P, k)) return 0;
  return (long long)global_blocks(Q) * block_slots(P, k);
}

// dists [Q, P] f32, ids [Q, P] int32 -> od [Q, k] f32, oi [Q, k] int32, and,
// if dups is not null, dups [Q] int64: each row's entries with an id >= 0
// less its distinct ids. ws holds dedup_topk_workspace(Q, P, k) slots (null
// where that is 0). Returns a cudaError_t.
int dedup_topk(const void* dists, const void* ids, int Q, int P, int k, void* od, void* oi,
               void* dups, void* ws, void* stream) {
  if (k < 1) return (int)cudaErrorInvalidValue;
  if (Q == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (fits_shared(P, k)) {
    const int smem = (int)(block_slots(P, k) * sizeof(unsigned long long));
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          dedup_topk_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
    }
    dedup_topk_kernel<true><<<Q, kThreads, smem, s>>>(
        (const float*)dists, (const int*)ids, Q, P, k, (float*)od, (int*)oi,
        (long long*)dups, nullptr);
  } else {
    if (ws == nullptr) return (int)cudaErrorInvalidValue;
    dedup_topk_kernel<false><<<global_blocks(Q), kThreads, 0, s>>>(
        (const float*)dists, (const int*)ids, Q, P, k, (float*)od, (int*)oi,
        (long long*)dups, (unsigned long long*)ws);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
