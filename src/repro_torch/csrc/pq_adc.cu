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
// What bounds it on an H100: bytes. The [Q, N] f32 output is written once
// (4 GB for 1,000 queries over 1M codes, ~1.2 ms at 3.35 TB/s); the LUTs and
// codes are tens of MB.
//
// What this simple design does about it:
//  * a block takes R query rows (their R x m x ks LUT floats in shared
//    memory, R = 4 at m = 16, ks = 256: 64 KB, so three blocks fit an SM)
//    and a chunk of 8,192 candidates; each thread takes one candidate of a
//    tile of 256 at a time, reads its m codes in their store dtype (uint8 or
//    uint16, never widened) and sums the R rows' distances in registers;
//  * the R stores of a tile go out coalesced along N, one row at a time;
//  * candidate chunks are the fastest grid index, so blocks in flight
//    together share their LUT rows in the card's L2.
// The gathers from shared memory meet bank conflicts (32 random codes over
// 32 banks); a layout that avoids them, and TMA stores, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunkN = 32 * kThreads;   // candidates per block
constexpr size_t kMaxSmem = 232448;      // 227 KB, the most a block can opt into
constexpr size_t kRowsSmem = 65536;      // the LUT rows' budget for three blocks an SM

size_t smem_bytes(int R, int m, int ks) { return (size_t)R * m * ks * sizeof(float); }

// Query rows per block: the largest of 8, 4, 2, 1 within the budget (1 as
// long as one row fits in a block's shared memory).
int pick_rows(int m, int ks) {
  int R = 8;
  while (R > 1 && smem_bytes(R, m, ks) > kRowsSmem) R >>= 1;
  return R;
}

template <typename CT, int R>
__global__ void __launch_bounds__(kThreads)
pq_adc_kernel(const float* __restrict__ lut, int Q, int m, int ks,
              const CT* __restrict__ codes, int N, float* __restrict__ out) {
  extern __shared__ __align__(16) float lut_s[];
  const int mks = m * ks;
  const int q0 = blockIdx.y * R;
  const int nr = min(R, Q - q0);
  const int tid = threadIdx.x;
  const float* src = lut + (size_t)q0 * mks;
  for (int e = tid; e < nr * mks; e += kThreads) lut_s[e] = src[e];
  __syncthreads();

  const int n_hi = (int)min((long long)N, (long long)(blockIdx.x + 1) * kChunkN);
  for (int n = blockIdx.x * kChunkN + tid; n < n_hi; n += kThreads) {
    const CT* cn = codes + (size_t)n * m;
    float acc[R];
    {
      const int code = cn[0];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = lut_s[r * mks + code];
    }
    for (int j = 1; j < m; ++j) {
      const int code = cn[j];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] += lut_s[r * mks + j * ks + code];
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (r < nr) out[(size_t)(q0 + r) * N + n] = acc[r];
  }
}

template <typename CT, int R>
int run(const void* lut, int Q, int m, int ks, const void* codes, int N, void* out,
        void* stream) {
  const size_t smem = smem_bytes(R, m, ks);
  cudaError_t err = cudaFuncSetAttribute(pq_adc_kernel<CT, R>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long row_groups = ((long long)Q + R - 1) / R;
  if (row_groups > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)(((long long)N + kChunkN - 1) / kChunkN), (unsigned)row_groups);
  pq_adc_kernel<CT, R><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)lut, Q, m, ks, (const CT*)codes, N, (float*)out);
  return (int)cudaGetLastError();
}

template <typename CT>
int launch(const void* lut, int Q, int m, int ks, const void* codes, int N, void* out,
           void* stream) {
  const int R = pick_rows(m, ks);
  if (smem_bytes(R, m, ks) > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (Q == 0 || N == 0) return 0;
  switch (R) {
    case 8: return run<CT, 8>(lut, Q, m, ks, codes, N, out, stream);
    case 4: return run<CT, 4>(lut, Q, m, ks, codes, N, out, stream);
    case 2: return run<CT, 2>(lut, Q, m, ks, codes, N, out, stream);
    default: return run<CT, 1>(lut, Q, m, ks, codes, N, out, stream);
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs at these widths, in bytes; above 232448 the
// launch is refused.
long long pq_adc_smem_bytes(int m, int ks) {
  return (long long)smem_bytes(pick_rows(m, ks), m, ks);
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
