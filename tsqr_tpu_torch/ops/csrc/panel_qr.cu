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

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "splits.cuh"

typedef __nv_bfloat16 bf16;

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
#define N_PHASES 12  // see PANEL_PHASES in harness/phase_profile.py
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

extern "C" {

int panel_qr_n_max(void) { return N_MAX; }
int panel_qr_l_max(void) { return L_MAX; }
int panel_qr_block(void) { return NB; }
long long panel_qr_smem_bytes(int L, int n) { return layout(L, n).total; }
long long panel_qr_smem_max(void) { return SMEM_MAX; }

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
