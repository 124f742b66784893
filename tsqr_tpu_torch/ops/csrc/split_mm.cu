// Batched products at a split mode, y[b] = x[b] @ c[b], on the tensor
// cores: x (B, M, K) and c (B, K, N) float32, y (B, M, N) float32.  The
// TSQR tree's Q build (core/tsqr.py) runs every product down the tree
// through it: the levels' (f n, n) Q against the (n, n) blocks of the
// level above, and the leaves' (L, n) Q against theirs.
//
// It replaces no TPU kernel: the JAX package leaves these products to
// XLA's matmul at the mode's precision.  Off the card the port ran them
// as modes.mm_bf16x6_cor does, six float32 matmuls of bf16-valued parts
// on the CUDA cores, each operand split into three panel-sized parts in
// device memory first and the six products added there.  At (2^20, 256)
// that was ~72 ms of a 140-ms tree.
//
// What bounds it on the H100.  At bf16x6_cor a product is six bf16
// products of 2 M K N flops; the tree at (2^20, 256) makes 0.32 TFLOP of
// them a pass, 1.9 TFLOP (1.9 ms at 989 TFLOP/s), against ~6 GB of x, c
// and y read and written once (1.8 ms at 3.35 TB/s): the two bounds sit
// together, so the design keeps the parts out of device memory and does
// the products on the tensor cores.
//
// The design, mma.sync first:
// * A CTA computes a BM x BN tile of one y[b] over k-slices of KS: x's
//   and c's float32 slices come through a STAGES-slot cp.async ring,
//   read through their strides: either operand may be stored with its
//   rows or its columns contiguous (the panel kernels return Q^T, which
//   the tree reads as the transposed view Q), and the ragged edges are
//   masked, zero-filled by the copies.
// * Each slice is split once a CTA into its 1, 2 or 3 bf16 parts in
//   shared memory (split_parts' arithmetic, two values a conversion),
//   double-buffered, so a slice's split and the previous slice's
//   products overlap across warps, with one barrier a slice.  Each parts
//   buffer keeps its operand's layout; ldmatrix (.trans where the layout
//   asks) gives the fragments.
// * The products that the mode keeps (fma_parts' set: one, three or six)
//   run on mma.sync m16n8k16, a warp 32 x 32 of the tile, into one
//   float32 accumulator per residual order.  Order 0 carries the
//   operands' magnitude: each k-step's product starts from zero and
//   joins its sum by a rounded add, so the tensor core's accumulation is
//   not repeated over K (stream_wide.cu's dot found it drift).  The
//   orders are added smallest first (sum_orders) and y is written once.
// * A CTA a tile, the tiles of one b together (its x rows shared from
//   L2), as a flat grid: any B, M, K and N; nothing is allocated here.
// * wgmma and TMA are not used yet.  At (4096, 256, 256, 256) a launch
//   takes 3.5 ms, 235 TFLOP/s of bf16 products, and 1.9 ms at one part:
//   the slices' loads and splits cost as much as five more products.
//   One CTA an SM holds the three orders' accumulators (~230 registers
//   a thread).  Persistent CTAs, a five-slot ring, L2 prefetches ahead
//   of the ring and 64 x 64 tiles at two CTAs an SM gained at most 4 %
//   (PERF.md): what bounds the one-part time is not measured yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_sync.cuh"  // cp.async, ldmatrix, mma_bf16, split4
#include "splits.cuh"    // sum_orders

#define THREADS 256
#define BM 128        // output rows of a CTA
#define BN 64         // output columns of a CTA
#define KS 32         // k-slice of a ring slot
#define STAGES 4      // the float32 ring
#define FPAD 4        // float32 padding of a staged row (16-byte rows)
#define HPAD 8        // bf16 padding of a parts row (ldmatrix banks)

typedef __nv_bfloat16 bf16;

// An operand's slice as staged and as split: ROWS x COLS of a matrix
// stored row-major with leading stride ld (its contiguous dimension is
// the slice's columns).
template <int ROWS, int COLS>
struct Tile {
  static constexpr int FSTR = COLS + FPAD;       // float32 a staged row
  static constexpr int HSTR = COLS + HPAD;       // bf16 a parts row
  static constexpr int FSLOT = ROWS * FSTR;      // floats a ring slot
  static constexpr int HPLANE = ROWS * HSTR;     // bf16 a part

  // Start the copy of rows row0.., columns col0.. into a ring slot; zero
  // past `rows` and `cols`.  16-byte copies where `fast` (cols, ld and
  // the base 16-byte multiples), else 4-byte ones.
  __device__ static void fetch(const float* base, long long ld, int row0,
                               int rows, int col0, int cols, int fast,
                               float* slot) {
    constexpr int PER = COLS / 4;
#pragma unroll
    for (int it = 0; it < ROWS * PER / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int r = i / PER, c = (i % PER) * 4;
      const int gr = row0 + r, gc = col0 + c;
      float* dst = slot + r * FSTR + c;
      const float* src = base + (long long)gr * ld + gc;
      if (fast) {
        const bool in = gr < rows && gc < cols;
        cp_async16(dst, in ? src : base, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = gr < rows && gc + e < cols;
          cp_async4(dst + e, in ? src + e : base, in ? 4 : 0);
        }
      }
    }
  }

  // Split a staged slot into its P parts, part q at parts + q * HPLANE.
  template <int P>
  __device__ static void split(const float* slot, bf16* parts) {
    constexpr int PER = COLS / 4;
#pragma unroll
    for (int it = 0; it < ROWS * PER / THREADS; ++it) {
      const int i = threadIdx.x + it * THREADS;
      const int r = i / PER, c = (i % PER) * 4;
      const float4 v = *reinterpret_cast<const float4*>(slot + r * FSTR + c);
      __nv_bfloat162 w[3][2];
      split4<P>(v, w);
#pragma unroll
      for (int q = 0; q < P; ++q)
        *reinterpret_cast<uint2*>(parts + q * HPLANE + r * HSTR + c) =
            make_uint2(bits(w[q][0]), bits(w[q][1]));
    }
  }
};

// x's slice: BM rows (m) x KS (k), or, stored transposed (XT), KS x BM;
// c's: KS (k) x BN (n), or, transposed (CT), BN x KS.
template <bool XT>
using XTile = Tile<XT ? KS : BM, XT ? BM : KS>;
template <bool CT>
using CTile = Tile<CT ? BN : KS, CT ? KS : BN>;

template <int CODE, bool XT, bool CT>
struct Layout {
  static constexpr int P = CODE <= 1 ? 1 : CODE;
  static constexpr int XF = XTile<XT>::FSLOT, CF = CTile<CT>::FSLOT;
  static constexpr int XH = P * XTile<XT>::HPLANE, CH = P * CTile<CT>::HPLANE;
  // the ring of float32 slices, then two buffers of parts
  static constexpr int BYTES = STAGES * (XF + CF) * 4 + 2 * (XH + CH) * 2;
};

struct Params {
  const float* x;
  const float* c;
  float* y;
  long long sxb, ldx, scb, ldc;  // batch and leading strides, elements
  int M, K, N, tiles_m, tiles_n, x_fast, c_fast;
};

// A warp's A fragments (two m16 tiles) of part buffer `xp` at k0.
template <bool XT>
__device__ __forceinline__ void load_a(uint32_t a[2][4], const bf16* xp,
                                       int wr, int k0, int lane) {
  constexpr int S = XTile<XT>::HSTR;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (XT)  // [k][m]: the 8 x 8 matrices transposed
      ldsm_x4_t(a[i], xp + (k0 + (lane & 7) + ((lane >> 4) & 1) * 8) * S +
                          wr + 16 * i + ((lane >> 3) & 1) * 8);
    else  // [m][k]
      ldsm_x4(a[i], xp + (wr + 16 * i + (lane & 15)) * S + k0 +
                        (lane >> 4) * 8);
  }
}

// The B fragments of two neighbouring n8 tiles (k0 .. k0+15, n0 .. n0+15)
// of part buffer `cp`.
template <bool CT>
__device__ __forceinline__ void load_b2(uint32_t b[2][2], const bf16* cp,
                                        int k0, int n0, int lane) {
  constexpr int S = CTile<CT>::HSTR;
  uint32_t t[4];
  if (CT)  // [n][k]
    ldsm_x4(t, cp + (n0 + (lane & 7) + ((lane >> 4) & 1) * 8) * S + k0 +
                   ((lane >> 3) & 1) * 8);
  else  // [k][n]: the 8 x 8 matrices transposed
    ldsm_x4_t(t, cp + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + n0 +
                     (lane >> 4) * 8);
  b[0][0] = t[0];
  b[0][1] = t[1];
  b[1][0] = t[2];
  b[1][1] = t[3];
}

template <int CODE, bool XT, bool CT>
__global__ void __launch_bounds__(THREADS, 1) split_mm_kernel(Params p) {
  using L = Layout<CODE, XT, CT>;
  using XTl = XTile<XT>;
  using CTl = CTile<CT>;
  constexpr int P = L::P, ORDER = P - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  bf16* parts = reinterpret_cast<bf16*>(ring + STAGES * (L::XF + L::CF));

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 32 * (warp & 3), wc = 32 * (warp >> 2);
  const long long per_b = (long long)p.tiles_m * p.tiles_n;
  const long long b = blockIdx.x / per_b;
  const int rem = (int)(blockIdx.x % per_b);
  const int m0 = (rem / p.tiles_n) * BM, n0 = (rem % p.tiles_n) * BN;
  const float* xb = p.x + b * p.sxb;
  const float* cb = p.c + b * p.scb;
  const int KT = (p.K + KS - 1) / KS;

  auto fetch = [&](int kt) {
    if (kt < KT) {
      float* slot = ring + (kt % STAGES) * (L::XF + L::CF);
      const int k0 = kt * KS;
      if (XT)
        XTl::fetch(xb, p.ldx, k0, p.K, m0, p.M, p.x_fast, slot);
      else
        XTl::fetch(xb, p.ldx, m0, p.M, k0, p.K, p.x_fast, slot);
      if (CT)
        CTl::fetch(cb, p.ldc, n0, p.N, k0, p.K, p.c_fast, slot + L::XF);
      else
        CTl::fetch(cb, p.ldc, k0, p.K, n0, p.N, p.c_fast, slot + L::XF);
    }
    cp_commit();
  };
  auto split = [&](int kt) {
    const float* slot = ring + (kt % STAGES) * (L::XF + L::CF);
    bf16* buf = parts + (kt & 1) * (L::XH + L::CH);
    XTl::template split<P>(slot, buf);
    CTl::template split<P>(slot + L::XF, buf + L::XH);
  };

  float acc[3][2][4][4];
#pragma unroll
  for (int s = 0; s < 3; ++s)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][i][j][e] = 0.f;

  if (KT > 0) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) fetch(s);
    cp_wait<STAGES - 2>();
    __syncthreads();
    split(0);
  }
  for (int kt = 0; kt < KT; ++kt) {
    // The slot of slice kt - 1 was split before the last barrier.
    fetch(kt + STAGES - 1);
    cp_wait<STAGES - 2>();
    // Slice kt + 1 has landed, slice kt's parts are written, and every
    // warp is done with slice kt - 1's parts.
    __syncthreads();
    if (kt + 1 < KT) split(kt + 1);
    const bf16* xp = parts + (kt & 1) * (L::XH + L::CH);
    const bf16* cp = xp + L::XH;
#pragma unroll
    for (int k0 = 0; k0 < KS; k0 += 16) {
      uint32_t af[3][2][4];
#pragma unroll
      for (int q = 0; q < P; ++q)
        load_a<XT>(af[q], xp + q * XTl::HPLANE, wr, k0, lane);
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {  // two n8 tiles of c at a time
        uint32_t bf[3][2][2];
#pragma unroll
        for (int q = 0; q < P; ++q)
          load_b2<CT>(bf[q], cp + q * CTl::HPLANE, k0, wc + 16 * jj, lane);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jl = 0; jl < 2; ++jl) {
            const int j = 2 * jj + jl;
#pragma unroll
            for (int s = ORDER; s >= 1; --s)
#pragma unroll
              for (int u = 0; u < P; ++u) {
                const int v = s - u;
                if (v >= 0 && v < P)
                  mma_bf16(acc[s][i][j], af[u][i], bf[v][jl][0],
                           bf[v][jl][1]);
              }
            float t0[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(t0, af[0][i], bf[0][jl][0], bf[0][jl][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc[0][i][j][e] = __fadd_rn(acc[0][i][j][e], t0[e]);
          }
      }
    }
  }
  cp_wait<0>();

  float* yb = p.y + b * (long long)p.M * p.N;
  const bool pairs = (p.N & 1) == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8
        const int row = m0 + wr + 16 * i + g + 8 * h;
        const int col = n0 + wc + 8 * j + 2 * t;
        if (row >= p.M || col >= p.N) continue;
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          v[e] = sum_orders(acc[0][i][j][2 * h + e], acc[1][i][j][2 * h + e],
                            acc[2][i][j][2 * h + e], ORDER);
        float* dst = yb + (long long)row * p.N + col;
        if (pairs) {
          *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
        } else {
          dst[0] = v[0];
          if (col + 1 < p.N) dst[1] = v[1];
        }
      }
}

template <int CODE, bool XT, bool CT>
static int launch_t(const Params& p, unsigned grid, cudaStream_t stream) {
  constexpr int smem = Layout<CODE, XT, CT>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      split_mm_kernel<CODE, XT, CT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  split_mm_kernel<CODE, XT, CT><<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int CODE>
static int launch_code(const Params& p, int xt, int ct, unsigned grid,
                       cudaStream_t stream) {
  if (xt)
    return ct ? launch_t<CODE, true, true>(p, grid, stream)
              : launch_t<CODE, true, false>(p, grid, stream);
  return ct ? launch_t<CODE, false, true>(p, grid, stream)
            : launch_t<CODE, false, false>(p, grid, stream);
}

static int aligned16(const void* ptr) {
  return ((uintptr_t)ptr & 15) == 0;
}

extern "C" {

// y (B, M, N) row-major = x @ c at `parts` bf16 parts (1, 2 or 3), one
// launch on `stream`.  x[b] is (M, K) at x + b sxb, row-major with
// leading stride ldx, or column-major (xt = 1: element (m, k) at
// k ldx + m); c[b] (K, N) at c + b scb likewise (ct = 1: (k, n) at
// n ldc + k).  Returns the launch's CUDA error code; an empty y launches
// nothing.
int split_mm_launch(const float* x, const float* c, float* y, int B, int M,
                    int K, int N, long long sxb, long long ldx, int xt,
                    long long scb, long long ldc, int ct, int parts,
                    void* stream) {
  if (parts < 1 || parts > 3 || B < 0 || M < 0 || K < 0 || N < 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)B * M * N == 0) return 0;
  Params p;
  p.x = x;
  p.c = c;
  p.y = y;
  p.sxb = sxb;
  p.ldx = ldx;
  p.scb = scb;
  p.ldc = ldc;
  p.M = M;
  p.K = K;
  p.N = N;
  p.tiles_m = (M + BM - 1) / BM;
  p.tiles_n = (N + BN - 1) / BN;
  // 16-byte copies where every row of the slice starts 16-byte aligned
  // and the contiguous extent is whole 16-byte chunks
  p.x_fast = aligned16(x) && sxb % 4 == 0 && ldx % 4 == 0 &&
             (xt ? M : K) % 4 == 0;
  p.c_fast = aligned16(c) && scb % 4 == 0 && ldc % 4 == 0 &&
             (ct ? K : N) % 4 == 0;
  const long long grid = (long long)B * p.tiles_m * p.tiles_n;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (parts) {
    case 1: return launch_code<1>(p, xt, ct, (unsigned)grid, s);
    case 2: return launch_code<2>(p, xt, ct, (unsigned)grid, s);
    default: return launch_code<3>(p, xt, ct, (unsigned)grid, s);
  }
}

}  // extern "C"
