// Batched Householder QR of (L, n) tiles: A (B, L, n) float32 ->
// Q^T (B, n, L) and R (B, n, n), one CTA per tile, the tile resident in
// shared memory from its load to its last write.
//
// Replaces the Pallas kernels that compute this function on the TPU:
//   B2 tsqr_tpu/ops/pallas_panel_sb.py::panel_qr_pallas_sb (T tiles share
//      one column chain, forward-accumulated W-Y form),
//   B3 tsqr_tpu/ops/pallas_panel.py::panel_qr_pallas (one tile per
//      program, compact WY (Y, T) per column block),
//   B4 docs/attic/pallas_panel_mt.py::panel_qr_pallas_mt (T tiles packed
//      in lanes).
// Their tile batching exists because Mosaic runs grid programs one after
// another on one core.  On the H100 the tiles are independent CTAs: the
// tree's 4096 leaf tiles at (2^20, 128) fill the 132 SMs 31 times over.
//
// The algorithm is LAPACK's geqrf + orgqr, blocked by NB = 16 columns, in
// compact WY (Y, T): R_jj = -sign(x_j) ||x|| with sign(0) = +1,
// v = x + sign(x_j) ||x|| e_j over rows >= j, beta = 2 / ||v||^2 or 0
// where ||v||^2 <= 1e-30 (a zero column passes through as H = I); the
// trailing update X -= Y (T^T (Y^T X)) and, from the right, the Q build
// Q -= Y (T (Y^T Q)) run at the mode; the small T products are float32.
//
// What bounds it on this card: at (4096, 256, 128) the one read of A and
// the writes of Q^T and R are 1.34 GB (0.40 ms at 3.35 TB/s), and the
// ~4 L n^2 flops a tile are, at bf16x6_cor, six split products of 69 GFLOP
// (0.42 ms on the tensor cores).  What bounds this design is the serial
// column chain of each tile: 128 dependent steps, each a reduction over
// the tile's rows.  The design:
// * The column chain in registers.  Each thread holds one row (RPT = 1,
//   L <= 256) or two (RPT = 2, L <= 512) of the current block's 16
//   columns, rotated so that the current column is always at index 0 (the
//   step is one loop body over constant register indices).  For column j
//   it forms, in one pass over its rows >= j, the dots D_c of column j
//   with all 16 block columns; a transposed warp butterfly leaves one sum
//   a lane, a warp writes its 16 partials and the owner of row j writes
//   that row, and after one barrier lane l of every warp sums entry l % 16
//   over the warps and shuffles the step's scalars to its warp.  Every
//   quantity of the step follows from D and row j: ||x||^2 = D_j, the dot
//   of v with column c is D_c + sign ||x|| x_jc (for c > j the rank-1
//   update, for the block's earlier reflectors Y^T v, kept for T).  The
//   rank-1 updates run in registers.  One CTA barrier a column (the
//   partials are double-buffered), where the first version took two plus
//   a loop of one-warp tasks.  T's recurrence leaves the chain: the last
//   warp forms T from the kept Y^T v while the others run Y^T X.
// * Split once.  At the end of a block each thread splits its rows of Y
//   into the mode's bf16 parts once, into shared memory rows of 24 bf16
//   (48 bytes: ldmatrix reads them without bank conflicts); W = T^T (Y^T X)
//   (T (Y^T Q) in the Q build) is split once into [k][column] rows.  The
//   trailing X is split where its tensor-core fragment is loaded, and each
//   element of it is loaded once a block.
// * Block products on the tensor cores: P^T = X^T Y (M = columns, K =
//   rows, N = the 16 reflectors) and X^T -= W^T Y^T (M = columns, K = 16,
//   N = rows) as mma.sync m16n8k16 over the parts, each residual order in
//   its own float32 fragment, the orders added smallest first (the stream
//   kernel's dot_mma).  The fp32 mode must not round its operands: its
//   products are float32 FMAs, register-blocked (Y^T X: a warp per column,
//   16 sums a lane; X - Y W: a thread per row, its Y row in registers).
// * Shared memory: the tile column-major with row stride sl = round_up(L,
//   32) + 8 (sl = 8 mod 32: the float2 fragment loads and stores of eight
//   columns by four row pairs hit 32 distinct banks), its columns padded
//   to a multiple of 16 with zeros, rows to a multiple of 16.  The
//   reflectors stay below the diagonal and R above it, as in geqrf; R is
//   written out, and Q is built in the same buffer block by block from the
//   right, each block's Y split aside first.  At (256, 128) this is
//   204 KB: one tile a CTA and one CTA an SM.  Two CTAs an SM would need
//   the tile under 113 KB, which a float32 (256, 128) tile alone exceeds
//   (131 KB); the chain's latency is hidden only across the SM's 8 warps.
// * Zero rows at positions >= n are never a pivot, so every reflector is
//   0 there and their Q rows come out exactly 0 (the tree pads with them).
// Measured at (4096, 256, 128) bf16x6_cor on an H100 (PERF.md): 6.7-6.9 ms
// against the first version's 93.3 ms; the chain takes ~38 % of a tile's
// cycles, the block products ~37 %.
//
// The cluster path (panel_qr_cluster_kernel, below).  A launch of fewer
// tiles than the card has SMs waits through one tile's serial time while
// most SMs idle: the TSQR tree's levels of 64, 32, ... 1 (256, 128) nodes.
// There each tile runs on a thread-block cluster of k = 2, 4 or 8 CTAs,
// block b of its 16-column W-Y blocks on CTA b % k: the owner of a block
// runs its chain and publishes Y (with what T is formed from) in its
// shared memory, the others read it over distributed shared memory and
// update their own columns, and each CTA builds its own columns of Q.  The wrapper
// (panel_kernel.cluster_size) takes the largest k <= min(8, ceil(n / 16))
// whose batch of clusters the card runs at once
// (cudaOccupancyMaxActiveClusters); launches of a wave or more, such as
// the tree's leaves, and n <= 16 keep one CTA a tile.  The outputs are
// those of one CTA a tile, bit for bit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "splits.cuh"

typedef __nv_bfloat16 bf16;
namespace cg = cooperative_groups;

#define THREADS 256
#define WARPS (THREADS / 32)
#define NB 16            // columns per W-Y block
#define N_MAX 128        // widest n
#define L_MAX (2 * THREADS)  // most rows: two a thread in the chain
#define YS 24            // bf16 a row of a Y part (16 + 8: conflict-free)
#define YF 20            // float32 a row of Y in the fp32 mode
#define SMEM_MAX 232448  // dynamic shared memory a block may use on sm_90
#define FULL 0xffffffffu

// Phase timers, compiled in only with -DPANEL_QR_PROFILE (see
// harness/phase_profile.py): thread 0 of each CTA adds the clock64() time
// since its previous mark to the phase that just ended.  Marks follow
// barriers, so a phase's time includes waiting for the slowest warp.
#define N_PHASES 12  // PANEL_PHASES, CLUSTER_PHASES in harness/phase_profile.py
#define MAX_PROFILED_CTAS 1024
#ifdef PANEL_QR_PROFILE
__device__ long long g_phase_cycles[MAX_PROFILED_CTAS * N_PHASES];
__shared__ long long phase_cycles[N_PHASES];
__shared__ long long phase_mark;
#define PHASE(k)                                          \
  do {                                                    \
    if (threadIdx.x == 0) {                               \
      const long long now_ = clock64();                   \
      phase_cycles[k] += now_ - phase_mark;               \
      phase_mark = now_;                                  \
    }                                                     \
  } while (0)
#else
#define PHASE(k) \
  do {           \
  } while (0)
#endif

// Byte offsets of the dynamic shared memory of an (L, n) tile.
struct Layout {
  int ncp, lp, sl, ws;         // padded columns, padded rows, strides
  int at, yb, wb, p, t, ytv, vd, red, rowj, total;
};

__host__ __device__ inline Layout layout(int L, int n) {
  Layout o;
  o.ncp = (n + NB - 1) / NB * NB;
  o.lp = (L + 15) / 16 * 16;
  o.sl = (L + 31) / 32 * 32 + 8;
  o.ws = o.ncp + 8;
  int off = 0;
  o.at = off;   off += o.ncp * o.sl * 4;     // the tile, float32
  o.yb = off;   off += 3 * o.lp * YS * 2;    // Y's parts (fp32: Y, YF a row)
  o.wb = off;   off += 3 * NB * o.ws * 2;    // W's parts (fp32: W^T)
  o.p = off;    off += NB * o.ncp * 4;       // Y^T X, [k][column]
  o.t = off;    off += o.ncp / NB * NB * NB * 4;  // every block's T
  o.ytv = off;  off += NB * NB * 4;          // the block's Y^T v, by column
  o.vd = off;   off += o.ncp * 4;            // each reflector's diagonal
  o.red = off;  off += 2 * WARPS * NB * 4;   // the chain's warp partials
  o.rowj = off; off += 2 * NB * 4;           // the chain's pivot row
  o.total = off;
  return o;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c += A B on the tensor cores: A 16x16 bf16 (row), B 16x8 bf16 (col),
// c 16x8 float32.  Fragment layout of mma.m16n8k16 (lane = 4 g + t):
// a = {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)},
// b = {(2t..2t+1, g), (2t+8..2t+9, g)}, c = {(g, 2t..2t+1), (g+8, ..)}.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The parts of (x, y) for a bf16 code, each part a packed bf16 pair.
template <int CODE>
__device__ __forceinline__ void split_pair(float x, float y, uint32_t o[3]) {
  float px[3], py[3];
  split_parts(x, CODE, px);
  split_parts(y, CODE, py);
#pragma unroll
  for (int q = 0; q < n_parts(CODE); ++q) o[q] = pack2(px[q], py[q]);
}

// One level of the transposed butterfly: lanes l and l ^ 2H exchange
// halves, so that each keeps the sums of H entries (the upper H where
// l & 2H).  A template level by level: as a loop over H, nvcc kept the
// loop and indexed d at run time.
template <int H>
__device__ __forceinline__ void fold_half(float (&d)[NB], int lane) {
  const bool up = lane & (2 * H);
#pragma unroll
  for (int c = 0; c < H; ++c) {
    const float send = up ? d[c] : d[c + H];
    const float keep = up ? d[c + H] : d[c];
    d[c] = __fadd_rn(keep, __shfl_xor_sync(FULL, send, 2 * H));
  }
}

// Sum of d[0..15] over the warp, transposed: after the butterfly, lane l
// with l even holds the sum of entry sum_index(l) (odd lanes a copy).
__device__ __forceinline__ float reduce16(float (&d)[NB], int lane) {
  fold_half<8>(d, lane);
  fold_half<4>(d, lane);
  fold_half<2>(d, lane);
  fold_half<1>(d, lane);
  return __fadd_rn(d[0], __shfl_xor_sync(FULL, d[0], 1));
}

__device__ __forceinline__ int sum_index(int lane) {
  return ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
         ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
}

// ---------------------------------------------------------------------
// Block products.

// P[k][c] = sum_{r_lo <= i < lp} Y[i][k] X[c][i] for c_lo <= c < ncp, as
// P^T = X^T Y on the tensor cores: a warp per 16 columns, X split where its
// A fragment is loaded (float2 pairs of rows), Y's parts by ldmatrix.
template <int CODE>
__device__ __forceinline__ void dots_mma(const float* At, int sl,
                                         const bf16* Yb, int ypart, int r_lo,
                                         int lp, int c_lo, int ncp, float* P,
                                         int warp, int lane) {
  constexpr int NP = CODE <= 1 ? 1 : CODE, ORDER = NP - 1;
  const int g = lane >> 2, t = lane & 3;
  for (int mt = c_lo / 16 + warp; mt < ncp / 16; mt += WARPS) {
    float acc[3][2][4];
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][j][e] = 0.f;
    const float* x0 = At + (mt * 16 + g) * sl + 2 * t;
    const float* x1 = x0 + 8 * sl;
#pragma unroll 2
    for (int k0 = r_lo; k0 < lp; k0 += 16) {
      const float2 v[4] = {*reinterpret_cast<const float2*>(x0 + k0),
                           *reinterpret_cast<const float2*>(x1 + k0),
                           *reinterpret_cast<const float2*>(x0 + k0 + 8),
                           *reinterpret_cast<const float2*>(x1 + k0 + 8)};
      uint32_t af[3][4], bf[3][4];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        uint32_t o[3];
        split_pair<CODE>(v[f].x, v[f].y, o);
#pragma unroll
        for (int q = 0; q < NP; ++q) af[q][f] = o[q];
      }
#pragma unroll
      for (int q = 0; q < NP; ++q)
        ldsm_x4_t(bf[q], Yb + q * ypart +
                             (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * YS +
                             (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int s = 0; s <= ORDER; ++s)
#pragma unroll
          for (int u = 0; u < NP; ++u) {
            const int w = s - u;
            if (w >= 0 && w < NP)
              mma_bf16(acc[s][j], af[u], bf[w][2 * j], bf[w][2 * j + 1]);
          }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = mt * 16 + g + (e >= 2 ? 8 : 0);
        const int k = j * 8 + 2 * t + (e & 1);
        P[k * ncp + col] =
            sum_orders(acc[0][j][e], acc[1][j][e], acc[2][j][e], ORDER);
      }
  }
}

// X[c][i] -= sum_k Y[i][k] W[k][c] for c_lo <= c < ncp, r_lo <= i < lp, as
// X^T -= W^T Y^T on the tensor cores (K = the 16 reflectors): a warp per
// 16 columns by 16 rows, W's and Y's parts by ldmatrix.
template <int CODE>
__device__ __forceinline__ void update_mma(float* At, int sl, const bf16* Yb,
                                           int ypart, const bf16* Wb,
                                           int wpart, int ws, int r_lo,
                                           int lp, int c_lo, int ncp,
                                           int warp, int lane) {
  constexpr int NP = CODE <= 1 ? 1 : CODE, ORDER = NP - 1;
  const int g = lane >> 2, t = lane & 3;
  const int nrt = (lp - r_lo) / 16, units = (ncp - c_lo) / 16 * nrt;
  for (int u = warp; u < units; u += WARPS) {
    const int c = c_lo + (u / nrt) * 16, i0 = r_lo + (u % nrt) * 16;
    uint32_t af[3][4], bf[3][4];
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      ldsm_x4_t(af[q], Wb + q * wpart +
                           ((lane & 7) + ((lane >> 4) & 1) * 8) * ws + c +
                           ((lane >> 3) & 1) * 8);
      ldsm_x4(bf[q], Yb + q * ypart +
                         (i0 + (lane & 7) + ((lane >> 4) & 1) * 8) * YS +
                         ((lane >> 3) & 1) * 8);
    }
    float acc[3][2][4];
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int s = 0; s <= ORDER; ++s)
#pragma unroll
        for (int v = 0; v < NP; ++v) {
          const int w = s - v;
          if (w >= 0 && w < NP)
            mma_bf16(acc[s][j], af[v], bf[w][2 * j], bf[w][2 * j + 1]);
        }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2* x = reinterpret_cast<float2*>(
            At + (c + g + 8 * h) * sl + i0 + 8 * j + 2 * t);
        float2 y = *x;
        y.x = __fsub_rn(y.x, sum_orders(acc[0][j][2 * h], acc[1][j][2 * h],
                                        acc[2][j][2 * h], ORDER));
        y.y = __fsub_rn(y.y, sum_orders(acc[0][j][2 * h + 1],
                                        acc[1][j][2 * h + 1],
                                        acc[2][j][2 * h + 1], ORDER));
        *x = y;
      }
  }
}

// The same two products at fp32 mode by float32 FMAs.  Y^T X: a warp per
// column, each lane its rows with the 16 sums in registers, then
// reduce16.  X - Y W: a thread per row, its Y row in registers, W^T rows
// (Wt[c][k]) read by broadcast.
__device__ __forceinline__ void dots_f32(const float* At, int sl,
                                         const float* Yf, int r_lo, int lp,
                                         int c_lo, int ncp, float* P,
                                         int warp, int lane) {
  for (int c = c_lo + warp; c < ncp; c += WARPS) {
    float d[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) d[k] = 0.f;
    for (int i = r_lo + lane; i < lp; i += 32) {
      const float x = At[c * sl + i];
      const float4* y = reinterpret_cast<const float4*>(Yf + i * YF);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = y[q];
        d[4 * q] = fmaf(v.x, x, d[4 * q]);
        d[4 * q + 1] = fmaf(v.y, x, d[4 * q + 1]);
        d[4 * q + 2] = fmaf(v.z, x, d[4 * q + 2]);
        d[4 * q + 3] = fmaf(v.w, x, d[4 * q + 3]);
      }
    }
    const float s = reduce16(d, lane);
    if (!(lane & 1)) P[sum_index(lane) * ncp + c] = s;
  }
}

__device__ __forceinline__ void update_f32(float* At, int sl, const float* Yf,
                                           const float* Wt, int r_lo, int lp,
                                           int c_lo, int ncp, int tid) {
  for (int i = r_lo + tid; i < lp; i += THREADS) {
    float y[NB];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(Yf + i * YF)[q];
      y[4 * q] = v.x;
      y[4 * q + 1] = v.y;
      y[4 * q + 2] = v.z;
      y[4 * q + 3] = v.w;
    }
    for (int c = c_lo; c < ncp; ++c) {
      const float4* w = reinterpret_cast<const float4*>(Wt + c * NB);
      float acc = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = w[q];
        acc = fmaf(y[4 * q], v.x, acc);
        acc = fmaf(y[4 * q + 1], v.y, acc);
        acc = fmaf(y[4 * q + 2], v.z, acc);
        acc = fmaf(y[4 * q + 3], v.w, acc);
      }
      float* x = At + c * sl + i;
      *x = __fsub_rn(*x, acc);
    }
  }
}

// W = T^T P (TRANS, the trailing update) or T P (the Q build) for
// c_lo <= c < ncp, in float32, then split once: W's parts in [k][c] rows of
// ws bf16, or at fp32 mode W^T in [c][k] rows of NB floats.  A thread per
// column and half of the 16 rows of W: its P column in registers, eight
// independent sums (T is stored by columns, T[q][k] at T[k NB + q]).
template <int CODE, bool TRANS>
__device__ __forceinline__ void form_w(const float* T, const float* P, int nb,
                                       int c_lo, int ncp, bf16* Wb, int wpart,
                                       int ws, float* Wt, int tid) {
  const int ncols = ncp - c_lo;
  if (tid >= 2 * ncols) return;
  const int c = c_lo + tid % ncols, k0 = tid / ncols * 8;
  float p[NB];
#pragma unroll
  for (int q = 0; q < NB; ++q) p[q] = q < nb ? P[q * ncp + c] : 0.f;
  float w[8];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int k = k0 + kk;
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < NB; ++q)
      if (TRANS ? q <= k : (q >= k && q < nb))
        t = fmaf(TRANS ? T[k * NB + q] : T[q * NB + k], p[q], t);
    w[kk] = k < nb ? t : 0.f;
  }
  if constexpr (CODE == 0) {
    float4* d = reinterpret_cast<float4*>(Wt + c * NB + k0);
    d[0] = make_float4(w[0], w[1], w[2], w[3]);
    d[1] = make_float4(w[4], w[5], w[6], w[7]);
  } else {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      float parts[3];
      split_parts(w[kk], CODE, parts);
#pragma unroll
      for (int q = 0; q < n_parts(CODE); ++q)
        Wb[q * wpart + (k0 + kk) * ws + c] = __float2bfloat16_rn(parts[q]);
    }
  }
}

// Row i of Y (16 reflector entries) into shared memory: its bf16 parts, or
// at fp32 mode the float32 row.
template <int CODE>
__device__ __forceinline__ void store_y(const float (&y)[NB], bf16* Yb,
                                        int ypart, int i) {
  if (CODE == 0) {
    float4* d = reinterpret_cast<float4*>(reinterpret_cast<float*>(Yb) +
                                          i * YF);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      d[q] = make_float4(y[4 * q], y[4 * q + 1], y[4 * q + 2], y[4 * q + 3]);
    return;
  }
  uint32_t w[3][8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    uint32_t o[3];
    split_pair<CODE>(y[2 * c], y[2 * c + 1], o);
#pragma unroll
    for (int q = 0; q < n_parts(CODE); ++q) w[q][c] = o[q];
  }
#pragma unroll
  for (int q = 0; q < n_parts(CODE); ++q) {
    uint4* d = reinterpret_cast<uint4*>(Yb + q * ypart + i * YS);
    d[0] = make_uint4(w[q][0], w[q][1], w[q][2], w[q][3]);
    d[1] = make_uint4(w[q][4], w[q][5], w[q][6], w[q][7]);
  }
}

// ---------------------------------------------------------------------
// The column chain.  xr holds this thread's rows tid + s THREADS of the
// block's 16 columns, rotated so that the current column k is xr[.][0]:
// block column k + c sits at c for c < 16 - k, and the block's earlier
// columns (their reflectors below the diagonal) at 16 - k + p.  So the
// step's code indexes registers by constants and runs as one loop over
// the columns: unrolled 16 times, the chain ran 1.4x slower (PERF.md).
// One barrier a column.

template <int RPT>
__device__ __forceinline__ void rotate(float (&xr)[RPT][NB]) {
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const float t0 = xr[s][0];
#pragma unroll
    for (int c = 0; c < NB - 1; ++c) xr[s][c] = xr[s][c + 1];
    xr[s][NB - 1] = t0;
  }
}

template <int RPT>
__device__ __forceinline__ void chain_step(const int k, const int c0,
                                           const int nb, float (&xr)[RPT][NB],
                                           float* T, float* ytv, float* red,
                                           float* rowj, float* vd, int& buf,
                                           int tid, int warp, int lane) {
  const int j = c0 + k;
  float d[NB];
#pragma unroll
  for (int c = 0; c < NB; ++c) d[c] = 0.f;
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int i = tid + s * THREADS;
    if (i >= j) {
#pragma unroll
      for (int c = 0; c < NB; ++c) d[c] = fmaf(xr[s][0], xr[s][c], d[c]);
    }
    if (i == j) {
      float4* rj = reinterpret_cast<float4*>(rowj + buf * NB);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        rj[q] = make_float4(xr[s][4 * q], xr[s][4 * q + 1], xr[s][4 * q + 2],
                            xr[s][4 * q + 3]);
    }
  }
  float* rb = red + buf * WARPS * NB;
  const float part = reduce16(d, lane);
  if (!(lane & 1)) rb[warp * NB + sum_index(lane)] = part;
  __syncthreads();
  PHASE(1);
  // lane l sums the partials of entry l % 16 over the 8 warps (4 here,
  // 4 in lane l ^ 16), then the step's scalars and v's dots with every
  // column reach all lanes by shuffles: 4 loads a lane where all 16 sums
  // in every lane took 36 (128-bit) loads a thread
  const int e = lane & (NB - 1);
  float de = 0.f;
#pragma unroll
  for (int q = 0; q < WARPS / 2; ++q)
    de = __fadd_rn(de, rb[(2 * q + (lane >> 4)) * NB + e]);
  de = __fadd_rn(__shfl_xor_sync(FULL, de, 16), de);
  const float xe = rowj[buf * NB + e];
  const float norm2 = __shfl_sync(FULL, de, 0);
  const float xjk = __shfl_sync(FULL, xe, 0);
  const float sign = xjk >= 0.f ? 1.f : -1.f;
  const float norm = sqrtf(norm2);
  const float vnorm2 = __fadd_rn(
      __fadd_rn(norm2, __fmul_rn(__fmul_rn(2.f * sign, norm), xjk)), norm2);
  const float beta = vnorm2 > 1e-30f ? __fdiv_rn(2.f, vnorm2) : 0.f;
  const float sn = __fmul_rn(sign, norm);
  const float v = __fadd_rn(xjk, sn);
  // vdot[c]: the dot of v with the column at c, D_c + sign ||x|| x_jc
  const float ve = __fadd_rn(de, __fmul_rn(sn, xe));
  float vdot[NB];
#pragma unroll
  for (int c = 1; c < NB; ++c) vdot[c] = __shfl_sync(FULL, ve, c);
  const int later = nb - k;  // the block's later columns sit at 1 .. later-1
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int i = tid + s * THREADS;
    if (i >= j) {
      const float y = i == j ? v : xr[s][0];
#pragma unroll
      for (int c = 1; c < NB; ++c)
        if (c < later)
          xr[s][c] = __fsub_rn(xr[s][c], __fmul_rn(__fmul_rn(beta, vdot[c]),
                                                   y));
      if (i == j) xr[s][0] = -sn;
    }
  }
  // Y^T v for the T recurrence (form_t, after the chain): the earlier
  // column p sits at lane p + 16 - k
  if (warp == 0 && lane < NB && lane + k >= NB)
    ytv[k * NB + lane + k - NB] = ve;
  if (tid == 0) {
    T[k * NB + k] = beta;
    vd[j] = v;
  }
  rotate(xr);
  buf ^= 1;
  PHASE(2);
}

// The block's T (stored by columns: T[q][p] at T[p NB + q]) from the
// chain's beta (T's diagonal) and Y^T v: T[:k, k] = -beta_k T[:k, :k]
// (Y^T v_k), one column after another, by one warp.
__device__ __forceinline__ void form_t(float* T, const float* ytv, int nb,
                                       int lane) {
  for (int k = 1; k < nb; ++k) {
    if (lane < k) {
      float t = 0.f;
#pragma unroll
      for (int p = 0; p < NB; ++p)
        if (p >= lane && p < k) t = fmaf(T[p * NB + lane], ytv[k * NB + p], t);
      T[k * NB + lane] = -T[k * NB + k] * t;
    }
    __syncwarp();
  }
}

template <int CODE, int RPT>
__global__ void __launch_bounds__(THREADS, 1)
panel_qr_kernel(const float* __restrict__ a, float* __restrict__ qt,
                float* __restrict__ r, int L, int n, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lo = layout(L, n);
  const int sl = lo.sl, lp = lo.lp, ncp = lo.ncp, ws = lo.ws;
  const int ypart = lp * YS, wpart = NB * ws;
  float* At = reinterpret_cast<float*>(smem + lo.at);
  bf16* Yb = reinterpret_cast<bf16*>(smem + lo.yb);
  const float* Yf = reinterpret_cast<const float*>(smem + lo.yb);
  bf16* Wb = reinterpret_cast<bf16*>(smem + lo.wb);
  float* Wt = reinterpret_cast<float*>(smem + lo.wb);
  float* P = reinterpret_cast<float*>(smem + lo.p);
  float* Tall = reinterpret_cast<float*>(smem + lo.t);
  float* ytv = reinterpret_cast<float*>(smem + lo.ytv);
  float* vd = reinterpret_cast<float*>(smem + lo.vd);
  float* red = reinterpret_cast<float*>(smem + lo.red);
  float* rowj = reinterpret_cast<float*>(smem + lo.rowj);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t tile = blockIdx.x;
  const int nblk = (n + NB - 1) / NB;
#ifdef PANEL_QR_PROFILE
  if (tid == 0) {
    for (int k = 0; k < N_PHASES; ++k) phase_cycles[k] = 0;
    phase_mark = clock64();
  }
#endif

  // ---- load: a thread per row, zeros past L and n ----
  const float* A = a + tile * L * n;
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int i = tid + s * THREADS;
    if (i >= lp) break;
    int c = 0;
    if (i < L) {
      const float* row = A + (size_t)i * n;
      if (vec) {
        for (; c < n; c += 4) {
          const float4 v = *reinterpret_cast<const float4*>(row + c);
          At[c * sl + i] = v.x;
          At[(c + 1) * sl + i] = v.y;
          At[(c + 2) * sl + i] = v.z;
          At[(c + 3) * sl + i] = v.w;
        }
      } else {
        for (; c < n; ++c) At[c * sl + i] = row[c];
      }
    }
    for (; c < ncp; ++c) At[c * sl + i] = 0.f;
  }
  __syncthreads();
  PHASE(0);

  // ---- factor: the chain of each block, then the trailing update ----
  int buf = 0;
  for (int b = 0; b < nblk; ++b) {
    const int c0 = b * NB, nb = min(NB, n - c0);
    float* T = Tall + b * NB * NB;
    const bool trail = c0 + nb < n;
    float xr[RPT][NB];
#pragma unroll
    for (int s = 0; s < RPT; ++s) {
      const int i = tid + s * THREADS;
#pragma unroll
      for (int k = 0; k < NB; ++k)
        xr[s][k] = i < lp ? At[(c0 + k) * sl + i] : 0.f;
    }
#pragma unroll 1
    for (int k = 0; k < nb; ++k)
      chain_step<RPT>(k, c0, nb, xr, T, ytv, red, rowj, vd, buf, tid, warp,
                      lane);
#pragma unroll 1
    for (int k = nb; k < NB; ++k) rotate(xr);  // back to block order
    __syncthreads();  // vd of the block's last column
#pragma unroll
    for (int s = 0; s < RPT; ++s) {
      const int i = tid + s * THREADS;
      if (i >= lp) break;
#pragma unroll
      for (int k = 0; k < NB; ++k) At[(c0 + k) * sl + i] = xr[s][k];
      if (trail && i >= c0) {
        float y[NB];
#pragma unroll
        for (int k = 0; k < NB; ++k)
          y[k] = (k >= nb || i < c0 + k)
                     ? 0.f
                     : (i == c0 + k ? vd[c0 + k] : xr[s][k]);
        store_y<CODE>(y, Yb, ypart, i);
      }
    }
    __syncthreads();
    PHASE(3);
    // the last warp forms T while the others run the block's Y^T X (the
    // trailing columns, at most 7 tiles of 16, leave it without a tile)
    if (warp == WARPS - 1) form_t(T, ytv, nb, lane);
    if (!trail) break;
    const int c_rest = c0 + nb;
    if constexpr (CODE == 0)
      dots_f32(At, sl, Yf, c0, lp, c_rest, ncp, P, warp, lane);
    else
      dots_mma<CODE>(At, sl, Yb, ypart, c0, lp, c_rest, ncp, P, warp, lane);
    __syncthreads();
    PHASE(4);
    form_w<CODE, true>(T, P, nb, c_rest, ncp, Wb, wpart, ws, Wt, tid);
    __syncthreads();
    PHASE(5);
    if constexpr (CODE == 0)
      update_f32(At, sl, Yf, Wt, c0, lp, c_rest, ncp, tid);
    else
      update_mma<CODE>(At, sl, Yb, ypart, Wb, wpart, ws, c0, lp, c_rest, ncp,
                       warp, lane);
    __syncthreads();
    PHASE(6);
  }
  __syncthreads();
  PHASE(3);

  // ---- R: the upper triangle, exact zeros below ----
  float* R = r + tile * n * n;
  for (int e = tid; e < n * n; e += THREADS) {
    const int i = e / n, c = e - i * n;
    R[e] = i <= c ? At[c * sl + i] : 0.f;
  }

  // ---- Q = H_0 ... H_{n-1} I_thin, blocks from the right ----
  for (int b = nblk - 1; b >= 0; --b) {
    const int c0 = b * NB, nb = min(NB, n - c0);
    const float* T = Tall + b * NB * NB;
    __syncthreads();
    PHASE(b == nblk - 1 ? 7 : 10);  // R's write, or the last Q update
    // the block's Y split aside, its columns set to those of I_thin
#pragma unroll
    for (int s = 0; s < RPT; ++s) {
      const int i = tid + s * THREADS;
      if (i >= lp) break;
      float y[NB];
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        const int c = c0 + k;
        float* x = At + c * sl + i;
        y[k] = (k < nb && i >= c) ? (i == c ? vd[c] : *x) : 0.f;
        *x = (k < nb && i == c) ? 1.f : 0.f;
      }
      if (i >= c0) store_y<CODE>(y, Yb, ypart, i);
    }
    __syncthreads();
    PHASE(8);
    if constexpr (CODE == 0)
      dots_f32(At, sl, Yf, c0, lp, c0, ncp, P, warp, lane);
    else
      dots_mma<CODE>(At, sl, Yb, ypart, c0, lp, c0, ncp, P, warp, lane);
    __syncthreads();
    PHASE(9);
    form_w<CODE, false>(T, P, nb, c0, ncp, Wb, wpart, ws, Wt, tid);
    __syncthreads();
    PHASE(5);
    if constexpr (CODE == 0)
      update_f32(At, sl, Yf, Wt, c0, lp, c0, ncp, tid);
    else
      update_mma<CODE>(At, sl, Yb, ypart, Wb, wpart, ws, c0, lp, c0, ncp,
                       warp, lane);
  }
  __syncthreads();
  PHASE(10);

  float* Q = qt + tile * n * L;
  for (int e = tid; e < n * L; e += THREADS) {
    const int c = e / L, i = e - c * L;
    Q[e] = At[c * sl + i];
  }
#ifdef PANEL_QR_PROFILE
  __syncthreads();
  PHASE(11);
  if (tid == 0 && blockIdx.x < MAX_PROFILED_CTAS)
    for (int k = 0; k < N_PHASES; ++k)
      g_phase_cycles[blockIdx.x * N_PHASES + k] = phase_cycles[k];
#endif
}

// ---------------------------------------------------------------------
// The cluster path: one tile over a cluster of k CTAs (k = 2, 4 or 8, at
// most the tile's blocks).  Block b belongs to CTA b % k, which holds its
// 16 columns (all rows) in slot b / k of its own tile: a CTA holds
// ceil(nblk / k) blocks' columns.  Per block j, in turn:
// * its owner runs the chain as panel_qr_kernel does, then publishes the
//   block's reflectors (Y's float32 rows >= c0, each a row of 16) in its
//   shared memory, where they stay until the CTA exits, beside the
//   chain's beta and Y^T v;
// * after a cluster barrier, every CTA copies beta and Y^T v and forms T
//   in its last warp (form_t, as the k = 1 kernel does), and each CTA that
//   owns blocks right of j reads Y through distributed shared memory,
//   splits it into its own parts (store_y, as the owner would) and applies
//   it to those columns (dots, form_w, update: the k = 1 kernel's functions
//   over its columns) while T forms.
// Look-ahead: the owner of block j + 1 applies Y_j to that block alone, runs
// its chain and publishes it before the next barrier; it applies Y_j to its
// later blocks after that barrier, followed by its own Y_{j+1}, while the
// owner of j + 2 runs its chain.  The barriers order the steps, so the
// critical path is a chain and one block's update a block.
// The Q build: column block i of Q is H_0 ... H_i applied to block i of
// I_thin, so each CTA builds its own columns from the published Y and its
// T of blocks i, i - 1, ..., 0, reading each published Y once more, the
// next one while the current one is applied.
// Every column sees the k = 1 kernel's operations in its order, each a
// function of that column alone, so the outputs are bitwise those of
// panel_qr_kernel.

// Byte offsets of a cluster CTA's dynamic shared memory for an (L, n) tile
// over k CTAs, sized for the CTA with the most blocks.
struct ClusterLayout {
  int nown, ncl, lp, sl, ws;  // blocks and columns a CTA holds at most
  int at, yp, yb, wb, p, t, ytv, vd, red, rowj, total;
};

__host__ __device__ inline ClusterLayout cluster_layout(int L, int n, int k) {
  ClusterLayout o;
  const int nblk = (n + NB - 1) / NB;
  o.nown = (nblk + k - 1) / k;
  o.ncl = o.nown * NB;
  o.lp = (L + 15) / 16 * 16;
  o.sl = (L + 31) / 32 * 32 + 8;
  o.ws = o.ncl + 8;
  int off = 0;
  o.at = off;   off += o.ncl * o.sl * 4;      // its columns, float32
  o.yp = off;   off += o.nown * o.lp * NB * 4;  // its blocks' Y, published
  o.yb = off;   off += 3 * o.lp * YS * 2;     // the applied Y's parts
  o.wb = off;   off += 3 * NB * o.ws * 2;     // W's parts (fp32: W^T)
  o.p = off;    off += NB * o.ncl * 4;        // Y^T X, [k][column]
  o.t = off;    off += nblk * NB * NB * 4;    // every block's T
  o.ytv = off;  off += NB * NB * 4;           // the block's Y^T v
  o.vd = off;   off += nblk * NB * 4;         // each reflector's diagonal
  o.red = off;  off += 2 * WARPS * NB * 4;    // the chain's warp partials
  o.rowj = off; off += 2 * NB * 4;            // the chain's pivot row
  o.total = off;
  return o;
}

// X -= Y (T^T (Y^T X)) (TRANS, the factor) or Q -= Y (T (Y^T Q)) (the Q
// build) for the reflectors of the block at c0 over this CTA's columns
// c_lo <= c < c_hi, with Y's parts in Yb and T in T; ends on a barrier.
template <int CODE, bool TRANS>
__device__ __forceinline__ void apply_block(float* At, int sl, bf16* Yb,
                                            int ypart, bf16* Wb, int wpart,
                                            int ws, float* P, const float* T,
                                            int c0, int nb, int lp, int c_lo,
                                            int c_hi, int tid, int warp,
                                            int lane, int ph) {
  const float* Yf = reinterpret_cast<const float*>(Yb);
  float* Wt = reinterpret_cast<float*>(Wb);
  if constexpr (CODE == 0)
    dots_f32(At, sl, Yf, c0, lp, c_lo, c_hi, P, warp, lane);
  else
    dots_mma<CODE>(At, sl, Yb, ypart, c0, lp, c_lo, c_hi, P, warp, lane);
  __syncthreads();
  PHASE(ph);
  form_w<CODE, TRANS>(T, P, nb, c_lo, c_hi, Wb, wpart, ws, Wt, tid);
  __syncthreads();
  PHASE(ph + 1);
  if constexpr (CODE == 0)
    update_f32(At, sl, Yf, Wt, c0, lp, c_lo, c_hi, tid);
  else
    update_mma<CODE>(At, sl, Yb, ypart, Wb, wpart, ws, c0, lp, c_lo, c_hi,
                     warp, lane);
  __syncthreads();
  PHASE(ph + 2);
}

template <int CODE, int RPT>
__global__ void __launch_bounds__(THREADS, 1)
panel_qr_cluster_kernel(const float* __restrict__ a, float* __restrict__ qt,
                        float* __restrict__ r, int L, int n, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int k = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const ClusterLayout lo = cluster_layout(L, n, k);
  const int sl = lo.sl, lp = lo.lp, ws = lo.ws;
  const int ypart = lp * YS, wpart = NB * ws;
  float* At = reinterpret_cast<float*>(smem + lo.at);
  float* Yp = reinterpret_cast<float*>(smem + lo.yp);
  bf16* Yb = reinterpret_cast<bf16*>(smem + lo.yb);
  bf16* Wb = reinterpret_cast<bf16*>(smem + lo.wb);
  float* P = reinterpret_cast<float*>(smem + lo.p);
  float* Tall = reinterpret_cast<float*>(smem + lo.t);
  float* ytv = reinterpret_cast<float*>(smem + lo.ytv);
  float* vd = reinterpret_cast<float*>(smem + lo.vd);
  float* red = reinterpret_cast<float*>(smem + lo.red);
  float* rowj = reinterpret_cast<float*>(smem + lo.rowj);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t tile = blockIdx.x / k;
  const int nblk = (n + NB - 1) / NB;
  const int ncl = (nblk - rank + k - 1) / k * NB;  // this CTA's columns
#ifdef PANEL_QR_PROFILE
  // phases: 0 load and stores, 1-2 the chain (chain_step's), 3 Y
  // published, 4 the cluster barrier, 5 beta and Y^T v copied, Y read and
  // split (and R), 6-8 the factor's dots, W and update, 9-11 the Q
  // build's
  if (tid == 0) {
    for (int p = 0; p < N_PHASES; ++p) phase_cycles[p] = 0;
    phase_mark = clock64();
  }
#endif
  // this CTA's blocks left of block b, so its first local column right of
  // them is below(b) * NB
  auto below = [&](int b) { return b > rank ? (b - rank + k - 1) / k : 0; };
  auto column = [&](int lc) { return (rank + lc / NB * k) * NB + lc % NB; };

  // ---- load: a thread per row, this CTA's columns, zeros past L and n ----
  const float* A = a + tile * L * n;
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int i = tid + s * THREADS;
    if (i >= lp) break;
    for (int lc0 = 0; lc0 < ncl; lc0 += NB) {
      const int c0 = column(lc0);
      float* x = At + lc0 * sl + i;
      int c = 0;
      if (i < L) {
        const float* row = A + (size_t)i * n + c0;
        if (vec) {
          for (; c < NB && c0 + c < n; c += 4) {
            const float4 v = *reinterpret_cast<const float4*>(row + c);
            x[c * sl] = v.x;
            x[(c + 1) * sl] = v.y;
            x[(c + 2) * sl] = v.z;
            x[(c + 3) * sl] = v.w;
          }
        } else {
          for (; c < NB && c0 + c < n; ++c) x[c * sl] = row[c];
        }
      }
      for (; c < NB; ++c) x[c * sl] = 0.f;
    }
  }
  __syncthreads();
  PHASE(0);

  // Block b's Y: its owner's published rows >= c0, read into registers
  // (fetch) and split into Yb (split_in), as the owner would split them.
  auto fetch = [&](int b, float (&y)[RPT][NB]) {
    const float* src = cluster.map_shared_rank(Yp, b % k) +
                       (size_t)(b / k) * lp * NB;
#pragma unroll
    for (int s = 0; s < RPT; ++s) {
      const int i = tid + s * THREADS;
      if (i < lp && i >= b * NB) {
        const float4* row = reinterpret_cast<const float4*>(src + i * NB);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = row[q];
          y[s][4 * q] = v.x;
          y[s][4 * q + 1] = v.y;
          y[s][4 * q + 2] = v.z;
          y[s][4 * q + 3] = v.w;
        }
      }
    }
  };
  auto split_in = [&](int b, const float (&y)[RPT][NB]) {
#pragma unroll
    for (int s = 0; s < RPT; ++s) {
      const int i = tid + s * THREADS;
      if (i < lp && i >= b * NB) store_y<CODE>(y[s], Yb, ypart, i);
    }
  };
  // Block b's beta (T's diagonal) and Y^T v, copied from its owner (the
  // owner's own are in place); the caller's next barrier ends the copy.
  auto take_t = [&](int b) {
    const int owner = b % k, nb = min(NB, n - b * NB);
    if (owner == rank) return;
    float* T = Tall + b * NB * NB;
    const float* tv = cluster.map_shared_rank(ytv, owner);
    const float* td = cluster.map_shared_rank(T, owner);
    if (tid < NB * NB) ytv[tid] = tv[tid];
    if (tid < nb) T[tid * NB + tid] = td[tid * NB + tid];
  };
  auto apply = [&](int b, int c_lo, int c_hi, auto trans) {
    const int c0 = b * NB;
    apply_block<CODE, decltype(trans)::value>(
        At, sl, Yb, ypart, Wb, wpart, ws, P, Tall + b * NB * NB, c0,
        min(NB, n - c0), lp, c_lo, c_hi, tid, warp, lane,
        decltype(trans)::value ? 6 : 9);
  };
  using Factor = std::true_type;  // W = T^T (Y^T X)
  using QBuild = std::false_type;  // W = T (Y^T Q)

  // The chain of this CTA's block j, as panel_qr_kernel's, then its Y
  // published (with its beta and Y^T v, from which each CTA forms T); the
  // caller's cluster barrier follows.
  int buf = 0;
  auto factor = [&](int j) {
    const int c0 = j * NB, nb = min(NB, n - c0);
    float* T = Tall + j * NB * NB;
    float* X = At + (j / k) * NB * sl;
    float* Y = Yp + (size_t)(j / k) * lp * NB;
    float xr[RPT][NB];
#pragma unroll
    for (int s = 0; s < RPT; ++s) {
      const int i = tid + s * THREADS;
#pragma unroll
      for (int c = 0; c < NB; ++c) xr[s][c] = i < lp ? X[c * sl + i] : 0.f;
    }
#pragma unroll 1
    for (int c = 0; c < nb; ++c)
      chain_step<RPT>(c, c0, nb, xr, T, ytv, red, rowj, vd, buf, tid, warp,
                      lane);
#pragma unroll 1
    for (int c = nb; c < NB; ++c) rotate(xr);  // back to block order
    __syncthreads();  // vd of the block's last column
#pragma unroll
    for (int s = 0; s < RPT; ++s) {
      const int i = tid + s * THREADS;
      if (i >= lp) break;
#pragma unroll
      for (int c = 0; c < NB; ++c) X[c * sl + i] = xr[s][c];
      if (i >= c0) {
        float y[NB];
#pragma unroll
        for (int c = 0; c < NB; ++c)
          y[c] = (c >= nb || i < c0 + c)
                     ? 0.f
                     : (i == c0 + c ? vd[c0 + c] : xr[s][c]);
        float4* d = reinterpret_cast<float4*>(Y + i * NB);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          d[q] = make_float4(y[4 * q], y[4 * q + 1], y[4 * q + 2],
                             y[4 * q + 3]);
      }
    }
    PHASE(3);
  };

  // ---- factor ----
  if (rank == 0) factor(0);
  bool deferred = false;  // Y_{j-1} still to apply to this CTA's blocks > j
  for (int j = 0; j < nblk; ++j) {
    cluster.sync();  // block j's Y, beta and Y^T v are published
    PHASE(4);
    const int next = j + 1;
    const bool ahead = next < nblk && next % k == rank;  // owns block j + 1
    // this CTA's blocks > j: all of them, or block j + 1 alone ahead of
    // its chain; the deferred Y_{j-1} (still in Yb) first
    const int lc_lo = below(next) * NB, lc_hi = ahead ? lc_lo + NB : ncl;
    const bool apply_j = lc_lo < lc_hi;
    float y[RPT][NB];
    take_t(j);
    if (apply_j) {
      fetch(j, y);
      if (deferred) apply(j - 1, lc_lo, lc_hi, Factor());
      split_in(j, y);
    }
    __syncthreads();
    PHASE(5);
    // T_j in the last warp, as panel_qr_kernel forms it, while the others
    // start on Y_j's dots (form_w reads T after the barrier that ends them)
    if (warp == WARPS - 1)
      form_t(Tall + j * NB * NB, ytv, min(NB, n - j * NB), lane);
    if (apply_j) apply(j, lc_lo, lc_hi, Factor());
    if (ahead) factor(next);
    deferred = ahead;
  }
  __syncthreads();

  // ---- R: this CTA's columns, exact zeros below the diagonal ----
  float* R = r + tile * n * n;
  for (int e = tid; e < n * ncl; e += THREADS) {
    const int i = e / ncl, lc = e - i * ncl, c = column(lc);
    if (c < n) R[(size_t)i * n + c] = i <= c ? At[lc * sl + i] : 0.f;
  }
  __syncthreads();

  // ---- Q: this CTA's columns, H_b applied for b from its last block down
  // to 0; a block's own columns set to those of I_thin when b reaches it;
  // the next block's Y read while this one's is applied ----
  float y[RPT][NB];
  const int last = rank + (ncl / NB - 1) * k;  // this CTA's last block
  fetch(last, y);
  for (int b = last; b >= 0; --b) {
    const int lc_lo = below(b) * NB, c0 = b * NB, nb = min(NB, n - c0);
    split_in(b, y);
    if (b > 0) fetch(b - 1, y);
    if (b % k == rank) {
      float* X = At + (b / k) * NB * sl;
#pragma unroll
      for (int s = 0; s < RPT; ++s) {
        const int i = tid + s * THREADS;
        if (i >= lp) break;
#pragma unroll
        for (int c = 0; c < NB; ++c)
          X[c * sl + i] = (c < nb && i == c0 + c) ? 1.f : 0.f;
      }
    }
    __syncthreads();
    PHASE(5);
    apply(b, lc_lo, ncl, QBuild());
  }
  cluster.sync();  // no CTA exits while another reads its published Y

  float* Q = qt + tile * n * L;
  for (int e = tid; e < ncl * L; e += THREADS) {
    const int lc = e / L, i = e - lc * L, c = column(lc);
    if (c < n) Q[(size_t)c * L + i] = At[lc * sl + i];
  }
#ifdef PANEL_QR_PROFILE
  __syncthreads();
  PHASE(0);
  if (tid == 0 && blockIdx.x < MAX_PROFILED_CTAS)
    for (int p = 0; p < N_PHASES; ++p)
      g_phase_cycles[blockIdx.x * N_PHASES + p] = phase_cycles[p];
#endif
}

template <int CODE, int RPT>
static int launch(const float* a, float* qt, float* r, int batch, int L,
                  int n, int vec, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      panel_qr_kernel<CODE, RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  panel_qr_kernel<CODE, RPT><<<batch, THREADS, smem, stream>>>(a, qt, r, L,
                                                                n, vec);
  return (int)cudaGetLastError();
}

template <int RPT>
static int launch_code(int code, const float* a, float* qt, float* r,
                       int batch, int L, int n, int vec, int smem,
                       cudaStream_t s) {
  switch (code) {
    case 0: return launch<0, RPT>(a, qt, r, batch, L, n, vec, smem, s);
    case 1: return launch<1, RPT>(a, qt, r, batch, L, n, vec, smem, s);
    case 2: return launch<2, RPT>(a, qt, r, batch, L, n, vec, smem, s);
    default: return launch<3, RPT>(a, qt, r, batch, L, n, vec, smem, s);
  }
}

typedef void (*ClusterKernel)(const float*, float*, float*, int, int, int);

static ClusterKernel cluster_kernel(int code, int rpt) {
  switch (code * 2 + rpt - 1) {
    case 0: return panel_qr_cluster_kernel<0, 1>;
    case 1: return panel_qr_cluster_kernel<0, 2>;
    case 2: return panel_qr_cluster_kernel<1, 1>;
    case 3: return panel_qr_cluster_kernel<1, 2>;
    case 4: return panel_qr_cluster_kernel<2, 1>;
    case 5: return panel_qr_cluster_kernel<2, 2>;
    case 6: return panel_qr_cluster_kernel<3, 1>;
    default: return panel_qr_cluster_kernel<3, 2>;
  }
}

static cudaLaunchConfig_t cluster_config(int grid, int k, int smem,
                                         cudaStream_t stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The cluster kernel for (L, n, code, k) with its shared memory set, or
// null where the path does not take the shape.
static ClusterKernel cluster_prepare(int L, int n, int code, int k,
                                     int* smem, cudaError_t* err) {
  *err = cudaSuccess;
  const int nblk = (n + NB - 1) / NB;
  if (n < 1 || n > N_MAX || L < n || L > L_MAX || code < 0 || code > 3 ||
      (k != 2 && k != 4 && k != 8) || k > nblk)
    return nullptr;
  *smem = cluster_layout(L, n, k).total;
  if (*smem > SMEM_MAX) return nullptr;
  ClusterKernel kern = cluster_kernel(code, L > THREADS ? 2 : 1);
  *err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  return *err == cudaSuccess ? kern : nullptr;
}

extern "C" {

int panel_qr_n_max(void) { return N_MAX; }
int panel_qr_l_max(void) { return L_MAX; }
int panel_qr_block(void) { return NB; }
long long panel_qr_smem_bytes(int L, int n) { return layout(L, n).total; }
long long panel_qr_smem_max(void) { return SMEM_MAX; }
long long panel_qr_cluster_smem_bytes(int L, int n, int k) {
  return cluster_layout(L, n, k).total;
}

// How many clusters of k CTAs of the cluster kernel for (L, n, code) the
// card runs at once, into *clusters (0 where the path does not take the
// shape).
int panel_qr_max_clusters(int L, int n, int code, int k, int* clusters) {
  *clusters = 0;
  int smem;
  cudaError_t err;
  ClusterKernel kern = cluster_prepare(L, n, code, k, &smem, &err);
  if (!kern) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(k, k, smem, 0, &attr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, kern, &cfg);
}

// Factor a (batch, L, n) batch as panel_qr_launch does, each tile over a
// cluster of k CTAs (the cluster kernel above).
int panel_qr_cluster_launch(const float* a, float* qt, float* r, int batch,
                            int L, int n, int code, int k, void* stream) {
  if (batch < 1) return (int)cudaErrorInvalidValue;
  int smem;
  cudaError_t err;
  ClusterKernel kern = cluster_prepare(L, n, code, k, &smem, &err);
  if (!kern) return (int)(err ? err : cudaErrorInvalidValue);
  const int vec = n % 4 == 0 && (uintptr_t)a % 16 == 0;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(batch * k, k, smem, (cudaStream_t)stream, &attr);
  err = cudaLaunchKernelEx(&cfg, kern, a, qt, r, L, n, vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

#ifdef PANEL_QR_PROFILE
// Copy the last launch's phase cycles, (MAX_PROFILED_CTAS, N_PHASES)
// int64, to the host.
int panel_qr_phase_cycles(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_phase_cycles,
                                   sizeof(long long) * MAX_PROFILED_CTAS *
                                       N_PHASES);
}
#endif

// Factor a (batch, L, n) float32 batch into qt (batch, n, L) and r
// (batch, n, n); code is the mode code of splits.cuh.
int panel_qr_launch(const float* a, float* qt, float* r, int batch, int L,
                    int n, int code, void* stream) {
  if (n < 1 || n > N_MAX || L < n || L > L_MAX || batch < 1 || code < 0 ||
      code > 3)
    return (int)cudaErrorInvalidValue;
  const int smem = layout(L, n).total;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int vec = n % 4 == 0 && (uintptr_t)a % 16 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return L > THREADS ? launch_code<2>(code, a, qt, r, batch, L, n, vec, smem, s)
                     : launch_code<1>(code, a, qt, r, batch, L, n, vec, smem, s);
}

}  // extern "C"
