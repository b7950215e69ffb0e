// The full ADC matrix, for sm_90a.
//
// Replaces the TPU kernel `pq_adc` (repro/kernels/pq_adc.py, `_pq_adc_kernel`):
//
//   dist[q, n] = sum_m lut[q, m, codes[n, m]]      lut [Q, m, ks], codes [N, m]
//
// summed over m in order with additions only, so nothing contracts into an
// FMA and the result equals the plain version bit for bit. The TPU kernel
// turns the lookups into a one-hot contraction on its matrix unit; here the
// LUT sits in shared memory and is read by gather.
//
// What bounds it on an H100: the gathers, Q·N·m reads from shared memory
// (1.6·10^10 for 1,000 queries over 1M codes at m = 16: 1.91 ms at 32 words
// a clock an SM), and the [Q, N] f32 output, written once (4 GB there, ~1.2
// ms at 3.35 TB/s); the LUTs and codes are tens of MB.
//
// The design is adc_tile.cuh's: a block stages R query rows' LUTs in slabs
// of V = 4 rows interleaved, at a padded stride, so one 16-byte gather reads
// a code's entries of four rows, the lanes of a gather share a candidate and
// differ in slab, and they meet fewer bank conflicts; each lane sums kT = 8
// consecutive candidates of its V rows and stores each row's as two 16-byte
// streaming stores (evict-first, so the 4 GB of output does not push the
// codes out of L2): a warp's stores fill whole 32-byte sectors of R row
// segments. Blocks are (row group, candidate range) pairs on a 1-D grid, the
// range fastest, so blocks in flight together share their LUT rows in L2
// and any Q is taken. (On an H100 at the main widths, slabs of four rows ran
// faster than one row a lane, and the stores cost little beside the
// gathers: tools/adc_ab.py, PERF.md §6.)

#include <cuda_runtime.h>
#include <stdint.h>

#include "adc_tile.cuh"

namespace {

using namespace adctile;

constexpr int kT = 8;  // consecutive candidates a lane sums and stores

template <typename CT, int NV, int V>
__global__ void __launch_bounds__(32 * kMaxWarps)
pq_adc_kernel(const float* __restrict__ lut, int Q, int m, int ks, const CT* __restrict__ codes,
              int N, int lgR, int splits, float* __restrict__ out) {
  extern __shared__ __align__(16) float st[];
  const int R = 1 << lgR, lgn = lgR - (V == 4 ? 2 : V == 2 ? 1 : 0);  // R / V slabs
  const int split = blockIdx.x % splits;
  const int q0 = (int)(blockIdx.x / splits) * R;
  const int nr = min(R, Q - q0);
  const int S = slab_stride(m, ks, R, V);
  stage_rows(st, lut, q0, nr, m * ks, S, V);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, W = blockDim.x >> 5;
  const int s = lane & ((1 << lgn) - 1), g = lane >> lgn;
  int lo, hi;
  range_of(N, split, splits, lo, hi);
  const bool vec = (N & 3) == 0;  // 16-byte aligned row segments
  using VT = typename Vec<V>::T;
  scan<CT, NV, V, kT>(
      reinterpret_cast<const VT*>(st + (size_t)s * S), m, ks, codes, lo, hi, g, (32 >> lgn) * kT,
      warp, W, [](int) {},
      [&](int c, const VT (&acc)[kT]) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int r = s * V + i;
          if (r >= nr) break;
          float* orow = out + (size_t)(q0 + r) * N;
          if (vec && c + kT <= hi) {
#pragma unroll
            for (int t = 0; t < kT; t += 4)
              __stcs(reinterpret_cast<float4*>(orow + c + t),
                     make_float4(part(acc[t], i), part(acc[t + 1], i), part(acc[t + 2], i),
                                 part(acc[t + 3], i)));
          } else {
#pragma unroll
            for (int t = 0; t < kT; ++t)
              if (c + t < hi) __stcs(orow + c + t, part(acc[t], i));
          }
        }
      });
}

template <typename CT>
using Kernel = void (*)(const float*, int, int, int, const CT*, int, int, int, float*);

template <typename CT, int NV>
Kernel<CT> kernel_for(int R) {
  return R >= 4 ? pq_adc_kernel<CT, NV, 4> : R == 2 ? pq_adc_kernel<CT, NV, 2>
                                                    : pq_adc_kernel<CT, NV, 1>;
}

template <typename CT>
Plan plan_for(int nv, int m, int ks) {
  auto smem = [=](int R, int) { return stage_bytes(R, slab_rows(R), m, ks); };
  return nv ? plan(kernel_for<CT, 1>, smem) : plan(kernel_for<CT, 0>, smem);
}

Plan plan_for(int code_size, int nv, int m, int ks) {
  return code_size == 2 ? plan_for<uint16_t>(nv, m, ks) : plan_for<uint8_t>(nv, m, ks);
}

// Candidate ranges: as many as fill the card's block places evenly.
int splits_of(const Plan& p, int Q, int N) {
  return splits_for(p, p.lgR < 0 ? 0 : (Q + (1 << p.lgR) - 1) >> p.lgR, N, 1 << 20);
}

template <typename CT>
int launch(const void* lut, int Q, int m, int ks, const void* codes, int N, void* out,
           void* stream) {
  const int nv = code_vectors(codes, m, sizeof(CT));
  const Plan p = plan_for<CT>(nv, m, ks);
  if (p.lgR < 0) return (int)cudaErrorInvalidValue;
  if (Q == 0 || N == 0) return 0;
  const int splits = splits_of(p, Q, N);
  const long long blocks = (long long)((Q + (1 << p.lgR) - 1) >> p.lgR) * splits;
  const Kernel<CT> kernel = nv ? kernel_for<CT, 1>(1 << p.lgR) : kernel_for<CT, 0>(1 << p.lgR);
  kernel<<<(unsigned)blocks, 32 * p.warps, p.smem, (cudaStream_t)stream>>>(
      (const float*)lut, Q, m, ks, (const CT*)codes, N, p.lgR, splits, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The launch at these widths on the current device, for codes whose base is
// 16-byte aligned: out = {rows a block R (0 when not even one row's LUT
// fits; refused), warps a block, candidate ranges, blocks an SM, shared
// memory a block in bytes (one row's stage when none fits)}. Returns a
// cudaError_t.
int pq_adc_plan(int Q, int N, int m, int ks, int code_size, long long* out) {
  const Plan p = plan_for(code_size, code_vectors(m, code_size), m, ks);
  out[0] = p.lgR < 0 ? 0 : 1 << p.lgR;
  out[1] = p.warps;
  out[2] = p.lgR < 0 ? 0 : splits_of(p, Q, N);
  out[3] = p.per_sm;
  out[4] = (long long)(p.lgR < 0 ? stage_bytes(1, 1, m, ks) : p.smem);
  return (int)cudaGetLastError();
}

// lut [Q, m, ks] f32, codes [N, m] uint8 or uint16 -> out [Q, N] f32.
// Returns a cudaError_t.
int pq_adc_u8(const void* lut, int Q, int m, int ks, const void* codes, int N, void* out,
              void* stream) {
  return launch<uint8_t>(lut, Q, m, ks, codes, N, out, stream);
}

int pq_adc_u16(const void* lut, int Q, int m, int ks, const void* codes, int N, void* out,
               void* stream) {
  return launch<uint16_t>(lut, Q, m, ks, codes, N, out, stream);
}

}  // extern "C"
