// Two memory-bandwidth probes over a float32 A (m, n), row-major:
//
// * read_reduce (a pure read): out (8, n) = sum over k of A[8k + j, c].
//   A group of 8 rows is 8n contiguous floats, so the function is the sum
//   of m/8 contiguous blocks of 8n floats, element by element.
// * copy (a read and a write): y = x * c elementwise, c = 1 + 2^-23 (the
//   float32 nearest 1.0000001).
//
// Replaces the Pallas probes scripts/bw_experiments.py::read_reduce
// (B5) and ::copy_kernel (B6).
//
// What bounds them on the H100: the bytes.  read_reduce reads m n 4 bytes
// and does one add per float; copy moves 2 m n 4 bytes and does one
// multiply per float: ~0.25 and ~0.125 flop per byte, three orders of
// magnitude below the card's ridge.  So both are written for the memory
// system alone: 16-byte (float4) loads and stores by neighbouring threads
// on neighbouring addresses, several loads in flight per thread, and a grid
// whose size the caller sets through the rows each CTA covers (the TPU
// probes' chunk).
//
// Design against the TPU kernels:
// * The TPU read probe runs its grid in order into one resident (8, n)
//   accumulator.  Here CTAs run concurrently: CTA b sums its contiguous
//   range of 8-row groups into its own (8, n) partial, and a second launch
//   (bw_read_sum_kernel) adds the partials in a fixed order.  No atomics,
//   so the result is the same from run to run.  Partials and their sum are
//   float64 (the card's float64 adds cost nothing next to the read); the
//   result is rounded to float32 once.
// * The copy gives each CTA one contiguous range of rows_per_cta rows, and
//   the caller's default is the smallest, 8 rows (4 KB at n = 128): the
//   card streams best with many short-lived CTAs walking memory in order,
//   as torch.mul's elementwise kernel does.  Measured at (2^22, 128)
//   (PERF.md): 8 rows a CTA runs within a few percent of torch.mul's
//   time; 2048-4096 rows a CTA ran ~6 % slower whatever the cache hints,
//   as did the first version's grid-stride loop over 1024 CTAs.  Its one
//   float32 multiply (__fmul_rn) gives the plain version's bits.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define UNROLL 8        // float4 loads in flight per thread
#define SUM_WARPS 32    // warps of a summing CTA (one per partial residue)

// partials[b][e] = sum over the 8-row groups g of CTA b of A[g 8n + e], in
// float64, e < 8n; CTA b covers groups [b gpc, (b + 1) gpc).  a4 is A as
// float4s, l4 = 8n / 4 = 2n float4s per group.
__global__ void __launch_bounds__(THREADS)
bw_read_kernel(const float4* __restrict__ a4, double* __restrict__ partials,
               long long groups, long long gpc, int l4) {
  const long long g0 = blockIdx.x * gpc;
  const long long g1 = g0 + gpc < groups ? g0 + gpc : groups;
  double* out = partials + (size_t)blockIdx.x * l4 * 4;
  for (int e = threadIdx.x; e < l4; e += THREADS) {
    double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
    long long g = g0;
    for (; g + UNROLL <= g1; g += UNROLL) {
      float4 v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) v[u] = a4[(size_t)(g + u) * l4 + e];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        s0 += v[u].x;
        s1 += v[u].y;
        s2 += v[u].z;
        s3 += v[u].w;
      }
    }
    for (; g < g1; ++g) {
      const float4 v = a4[(size_t)g * l4 + e];
      s0 += v.x;
      s1 += v.y;
      s2 += v.z;
      s3 += v.w;
    }
    out[4 * e] = s0;
    out[4 * e + 1] = s1;
    out[4 * e + 2] = s2;
    out[4 * e + 3] = s3;
  }
}

// out[e] = float32(sum over b of partials[b][e]).  A CTA owns 32 entries;
// warp w adds the partials b = w, w + 32, ... in order (one coalesced
// 32-entry row per step), and thread w = 0 then adds the 32 warp sums in
// order w = 0 .. 31: a fixed order for every entry.
__global__ void __launch_bounds__(SUM_WARPS * 32)
bw_read_sum_kernel(const double* __restrict__ partials,
                   float* __restrict__ out, int grid, int nn) {
  __shared__ double warp_sum[SUM_WARPS][33];
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int e = blockIdx.x * 32 + lane;
  double s = 0.0;
  if (e < nn)
    for (int b = w; b < grid; b += SUM_WARPS) s += partials[(size_t)b * nn + e];
  warp_sum[w][lane] = s;
  __syncthreads();
  if (w == 0 && e < nn) {
    double t = 0.0;
    for (int k = 0; k < SUM_WARPS; ++k) t += warp_sum[k][lane];
    out[e] = (float)t;
  }
}

// y = x * c over `total` floats.  CTA b covers its own contiguous range
// of per_cta floats (rows_per_cta rows): float4s with up to UNROLL loads
// in flight a thread, neighbouring threads on neighbouring float4s, then
// the scalar tail in the last CTA.  Loads go through the read-only path
// (ld.global.nc), stores carry the streaming hint (st.global.cs).
__global__ void __launch_bounds__(THREADS)
bw_copy_kernel(const float* __restrict__ x, float* __restrict__ y,
               long long total, long long per_cta, float c) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  const long long lo = (long long)blockIdx.x * per_cta;
  const long long hi = lo + per_cta < total ? lo + per_cta : total;
  const long long e4 = hi / 4;  // lo is a multiple of 4
  long long i = lo / 4 + threadIdx.x;
  for (; i + (UNROLL - 1) * THREADS < e4; i += UNROLL * THREADS) {
    float4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = __ldg(x4 + i + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      v[u].x = __fmul_rn(v[u].x, c);
      v[u].y = __fmul_rn(v[u].y, c);
      v[u].z = __fmul_rn(v[u].z, c);
      v[u].w = __fmul_rn(v[u].w, c);
      __stcs(y4 + i + u * THREADS, v[u]);
    }
  }
  for (; i < e4; i += THREADS) {
    float4 v = __ldg(x4 + i);
    v.x = __fmul_rn(v.x, c);
    v.y = __fmul_rn(v.y, c);
    v.z = __fmul_rn(v.z, c);
    v.w = __fmul_rn(v.w, c);
    __stcs(y4 + i, v);
  }
  if (hi == total)
    for (long long j = e4 * 4 + threadIdx.x; j < total; j += THREADS)
      y[j] = __fmul_rn(x[j], c);
}

extern "C" {

// A (m, n) float32, m a multiple of 8, 16-byte aligned; partials
// (grid, 8, n) float64 with grid = ceil((m / 8) / gpc).
int bw_read_launch(const void* a, double* partials, long long m, int n,
                   long long gpc, int grid, void* stream) {
  if (m < 8 || m % 8 || n < 1 || gpc < 1 || grid < 1 ||
      (long long)grid * gpc < m / 8 || (uintptr_t)a % 16)
    return (int)cudaErrorInvalidValue;
  bw_read_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float4*>(a), partials, m / 8, gpc, 2 * n);
  return (int)cudaGetLastError();
}

int bw_read_sum(const double* partials, float* out, int grid, int nn,
                void* stream) {
  if (grid < 1 || nn < 1) return (int)cudaErrorInvalidValue;
  bw_read_sum_kernel<<<(nn + 31) / 32, SUM_WARPS * 32, 0,
                       (cudaStream_t)stream>>>(partials, out, grid, nn);
  return (int)cudaGetLastError();
}

// x and y: `total` float32s each, 16-byte aligned; CTA b covers floats
// [b per_cta, (b + 1) per_cta), per_cta a multiple of 4.
int bw_copy_launch(const void* x, void* y, long long total, long long per_cta,
                   float c, int grid, void* stream) {
  if (total < 1 || grid < 1 || per_cta < 4 || per_cta % 4 ||
      (long long)grid * per_cta < total || (uintptr_t)x % 16 ||
      (uintptr_t)y % 16)
    return (int)cudaErrorInvalidValue;
  bw_copy_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(x), static_cast<float*>(y), total, per_cta,
      c);
  return (int)cudaGetLastError();
}

}  // extern "C"
