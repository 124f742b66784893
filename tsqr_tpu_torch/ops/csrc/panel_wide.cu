// Batched Householder QR of wide (L, n) tiles, 128 < n <= 512: A (B, L, n)
// float32 -> Q^T (B, n, L) and R (B, n, n), the tile in device memory,
// factored 16 columns at a time and updated 64 columns at a time.
//
// Replaces the wide range of the Pallas kernel that computes this
// function on the TPU:
//   B2 wide  tsqr_tpu/ops/pallas_panel_sb.py::panel_qr_pallas_sb for
//            128 < n <= 512 (T tiles of L <= 8192 / T rows share one
//            column chain, tsqr_tpu/core/tsqr.py::_pick_sb_tiles), and
//   B3       tsqr_tpu/ops/pallas_panel.py::panel_qr_pallas in the same
//            range.
// The n <= 128 range is panel_qr.cu's, which keeps the whole tile in one
// CTA's shared memory.  Past n = 128 that does not hold: at n = 256 and
// L = 2n the float32 tile alone is 512 KiB, and at (1024, 512) 2 MiB,
// against the 227 KB a CTA can use (and 8 x 227 KB for a cluster).
//
// The function is panel_qr.cu's and B3's: LAPACK's geqrf + orgqr in
// compact WY (Y, T) blocks of NB = 16 columns: R_jj = -sign(x_j) ||x||
// with sign(0) = +1, v = x + sign(x_j) ||x|| e_j over rows >= j, beta =
// 2 / ||v||^2 or 0 where ||v||^2 <= 1e-30 (a zero column passes through as
// H = I).  Past panel_qr.cu it blocks on two levels, as LAPACK's recursive
// and multi-level geqrf do: four blocks make a panel of PW = 64 columns (a
// last panel takes the columns left: 8 at n = 136, 8 at n = 200).  A
// block's update X -= Y (T^T (Y^T X)) reaches only its own panel's later
// columns; the factored panel, its T merged to 64 x 64, updates the
// columns right of it in one pass, and the Q build runs from the right by
// panels, Q -= Y (T (Y^T Q)).  The block products run at the mode; the
// small T products and the Gram Y^T Y that merges T are float32.  Zero
// rows below every pivot stay zero in every reflector, so their Q rows
// come out exactly 0 (the tree pads with them).
//
// What bounds it on this card: at (4096, 256, 256) bf16x6_cor (the
// (2^20, 256) tree's leaves) one read of A and the writes of Q^T and R
// are 2.1 GB (0.64 ms at 3.35 TB/s); the ~4 L n^2 - 4 n^3 / 3 flops a
// tile are, at six split products, 1.1 TFLOP (1.1 ms on the tensor
// cores).  Applying each 16-column block to all the columns right of it
// would move ~42 GB there, counted from that launch sequence; this
// design moves ~21 GB (the wide applies 6.4, the narrow
// ones 2.8, the load and R 4.3, the split Y 3.0) in ~23 ms, ~0.9 TB/s:
// half of it the wide applies on mma.sync at one or two CTAs an SM, the
// rest launches a tile's CTAs wait through in turn (the chain, the narrow
// updates, the split).  The design, simple first:
// * The work tile X (B, n, Lp) is A transposed, column-major, rows
//   padded with zeros to Lp = round_up(L, 16) (wide_load_kernel).  It
//   ends holding R above the diagonal and the reflectors below it, as in
//   geqrf; each reflector's diagonal entry goes to vd, each block's T to
//   tm.
// * Per block of 16 columns: wide_factor_kernel, a CTA a tile, runs the
//   block's column chain as panel_qr.cu does (each thread its RPT <= 4
//   rows of the block's columns in registers, rotated so the current
//   column is register 0, one barrier a column) and writes the block
//   back with vd and T.  Unless it is its panel's last, wide_apply_kernel
//   applies it to the panel's later columns (48, 32, 16): a CTA a (chunk
//   of CW = 32 columns, tile), two passes over 64-row tiles staged in
//   shared memory, P = Y^T X (a warp a 16-column by 16-row unit, the
//   units' partials summed in a fixed order), W = T^T P in float32, split
//   once, then X -= Y W.  The narrow updates run on this simple kernel,
//   which reads its columns twice: at most 48 columns, they move less
//   than half the bytes of the wide ones.  On wide_outer_kernel, with a
//   block's Y split into ys and its T padded into the panel's 64 x 64,
//   they took longer on an H100 (bf16x6_cor, ms a call for all of
//   them): 9.14 against 3.52 at (4096, 256, 256), 13.90 against 5.78 at
//   (1024, 1024, 256), 9.17 against 3.22 at (1024, 512, 512); the outer
//   launches alone, without the split, 5.39, 7.60 and 5.21 (a 16-column
//   block is a quarter of the outer kernel's 64-wide products).
// * Per factored panel, wide_panel_kernel, a CTA a tile, writes the
//   panel's Y (vd on the diagonal, 0 above it) to ys split into the
//   mode's bf16 parts, [part][row][64] (the fp32 mode: float32
//   [row][64]), the layout the wide apply copies as it is, and forms the
//   panel's T: the Gram of Y in float32 FMAs, then T = [[T1, -T1 (Y1^T
//   Y2) T2], [0, T2]] a block at a time.  wide_outer_kernel then applies
//   the panel to all the columns right of it: a CTA a (chunk of 32
//   columns, tile), the chunk index fastest in the grid so that a tile's
//   CTAs run together and its Y comes from L2 after the first.  The
//   chunk's rows c0 .. Lp stay in shared memory (<= 132 KB at Lp = 1024)
//   from pass 1 (P = Y^T M) to pass 2 (M -= Y W, W = T^T P in float32,
//   split once), so M is read once and written once; Y's 64-row tiles
//   come in through a two-slot cp.async ring in both passes.
// * The Q build runs wide_outer_kernel over the panels from the right,
//   Q -= Y (T (Y^T Q)) into Q^T's layout, the panel's own columns
//   generated as those of I_thin, whose P = Y^T e_c is Y's row c: a CTA
//   of those columns reads it from ys and runs pass 2 alone.  Each
//   panel's Y is split again first (ys holds one panel; the T's are
//   kept).  2 nblk + 3 npan launches a
//   call, 2 npan - 1 of them wide applies: 44 and 7 at n = 256, 88 and 15
//   at n = 512.
// * The block products run on mma.sync m16n8k16 over the mode's bf16
//   parts (splits.cuh), each residual order in its own float32 fragment,
//   orders added smallest first; order 0 joins its sum by a rounded add a
//   k-step (the tensor core's own float32 accumulation drifted 1.2e-6
//   from the plain version over long sums in stream_wide.cu).  The fp32
//   mode must not round its operands: its products are float32 FMAs.
// * Kept out for now: wgmma (64-row warpgroup products want the chunk's
//   columns as the long side), the tile resident in a cluster (8 x 227 KB
//   hold a (1024, 256) tile but not a (1024, 512) one), TMA for the ring,
//   and the chain's launch a block.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "splits.cuh"

#define THREADS 256
#define WARPS (THREADS / 32)
#define NB 16              // columns per W-Y block
#define N_WIDE_MAX 512     // widest n
#define L_WIDE_MAX 1024    // most rows: four a thread in the chain
#define ROW_PAD 16         // the work tile's rows are padded to this
#define PW 64              // columns per panel: four blocks
#define CW 32              // columns of an apply CTA
#define RT 64              // rows of a staged row tile
#define MS (RT + 8)        // float32 stride of a staged column (8 mod 32)
#define YS 24              // bf16 a row of a staged Y part (conflict-free)
#define YF 20              // float32 a row of staged Y in the fp32 mode
#define WS (CW + 8)        // bf16 a row of a W part
#define YP (PW + 8)        // bf16 a row of a staged panel Y part
#define YPF (PW + 4)       // float32 a row of staged panel Y (fp32 mode)
#define YT (RT + 4)        // float32 a column of a staged row tile of panel Y
#define WPF (PW + 4)       // float32 a column of the fp32 mode's panel W^T
#define YS_ROW 384         // bytes a row of ys: 64 entries, three bf16 parts
#define FULL 0xffffffffu

static_assert(THREADS == NB * NB, "a thread an entry of T");
static_assert(THREADS == 4 * RT && CW == 4 * WARPS, "the warp roles");
static_assert(PW == 4 * NB && PW == 2 * CW, "the panel roles");

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

// The products of one k-step at the mode into acc[order]: order 0 by a
// fresh fragment joined with a rounded add, the higher orders in place.
template <int NP>
__device__ __forceinline__ void mma_orders(float (&acc)[3][4],
                                           const uint32_t (&af)[3][4],
                                           const uint32_t (&bf)[3][4],
                                           int j) {
  float c0[4] = {0.f, 0.f, 0.f, 0.f};
  mma_bf16(c0, af[0], bf[0][2 * j], bf[0][2 * j + 1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[0][e] = __fadd_rn(acc[0][e], c0[e]);
#pragma unroll
  for (int s = 1; s < NP; ++s)
#pragma unroll
    for (int u = 0; u < NP; ++u) {
      const int w = s - u;
      if (w >= 0 && w < NP)
        mma_bf16(acc[s], af[u], bf[w][2 * j], bf[w][2 * j + 1]);
    }
}

// One level of the transposed butterfly: lanes l and l ^ 2H exchange
// halves, so that each keeps the sums of H entries (the upper H where
// l & 2H).  Template levels: as a loop over H, nvcc kept the loop and
// indexed d at run time (panel_qr.cu).
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
// The load: A (B, L, n) row-major -> X (B, n, Lp) column-major, zeros in
// rows L .. Lp.  A CTA a (tile, 32 columns), 32 x 32 blocks through
// shared memory so that both sides are read and written along rows.

__global__ void __launch_bounds__(THREADS)
wide_load_kernel(const float* __restrict__ a, float* __restrict__ x, int L,
                 int Lp, int n) {
  __shared__ float blk[32][33];
  const size_t tile = blockIdx.x;
  const int cb = blockIdx.y * 32, tx = threadIdx.x & 31,
            ty = threadIdx.x >> 5;
  const float* A = a + tile * L * n;
  float* X = x + tile * n * Lp;
  for (int r0 = 0; r0 < Lp; r0 += 32) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int i = r0 + ty + 8 * q, c = cb + tx;
      blk[ty + 8 * q][tx] = (i < L && c < n) ? A[(size_t)i * n + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = cb + ty + 8 * q, i = r0 + tx;
      if (c < n && i < Lp) X[(size_t)c * Lp + i] = blk[tx][ty + 8 * q];
    }
    __syncthreads();
  }
}

// R: the upper triangle of X's first n rows, exact zeros below.
__global__ void __launch_bounds__(THREADS)
wide_r_kernel(const float* __restrict__ x, float* __restrict__ r, int Lp,
              int n) {
  const size_t tile = blockIdx.x;
  const float* X = x + tile * n * Lp;
  float* R = r + tile * n * n;
  for (int e = threadIdx.x; e < n * n; e += THREADS) {
    const int i = e / n, c = e - i * n;
    R[e] = i <= c ? X[(size_t)c * Lp + i] : 0.f;
  }
}

// ---------------------------------------------------------------------
// The column chain of one block, as panel_qr.cu runs it.  xr holds this
// thread's rows tid + s THREADS of the block's 16 columns, rotated so that
// the current column k is xr[.][0]: block column k + c sits at c for
// c < 16 - k, and the block's earlier columns (their reflectors below the
// diagonal) at 16 - k + p.  One barrier a column.

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

// Column k of the block whose first column is c0; vd[k] gets the
// reflector's diagonal entry, T[k][k] its beta, ytv[k] the dots of v with
// the block's earlier reflectors.
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
  // lane l sums the partials of entry l % 16 over the 8 warps (4 here,
  // 4 in lane l ^ 16); the step's scalars reach all lanes by shuffles
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
  // Y^T v for the T recurrence: the earlier column p sits at lane
  // p + 16 - k
  if (warp == 0 && lane < NB && lane + k >= NB)
    ytv[k * NB + lane + k - NB] = ve;
  if (tid == 0) {
    T[k * NB + k] = beta;
    vd[k] = v;
  }
  rotate(xr);
  buf ^= 1;
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

// Block b of every tile: its column chain on the columns the previous
// blocks' updates left, then the block, vd and T back to device memory.
template <int RPT>
__global__ void __launch_bounds__(THREADS)
wide_factor_kernel(float* __restrict__ x, float* __restrict__ vd,
                   float* __restrict__ tm, int Lp, int n, int b) {
  __shared__ __align__(16) float T[NB * NB];
  __shared__ __align__(16) float ytv[NB * NB];
  __shared__ __align__(16) float red[2 * WARPS * NB];
  __shared__ __align__(16) float rowj[2 * NB];
  __shared__ float vds[NB];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t tile = blockIdx.x;
  const int nblk = (n + NB - 1) / NB, c0 = b * NB, nb = min(NB, n - c0);
  float* X = x + tile * n * Lp;
  T[tid] = 0.f;  // THREADS == NB * NB: T past nb stays 0
  float xr[RPT][NB];
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int i = tid + s * THREADS;
#pragma unroll
    for (int k = 0; k < NB; ++k)
      xr[s][k] = (i >= c0 && i < Lp && k < nb) ? X[(size_t)(c0 + k) * Lp + i]
                                               : 0.f;
  }
  __syncthreads();
  int buf = 0;
#pragma unroll 1
  for (int k = 0; k < nb; ++k)
    chain_step<RPT>(k, c0, nb, xr, T, ytv, red, rowj, vds, buf, tid, warp,
                    lane);
#pragma unroll 1
  for (int k = nb; k < NB; ++k) rotate(xr);  // back to block order
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int i = tid + s * THREADS;
    if (i >= c0 && i < Lp) {
#pragma unroll
      for (int k = 0; k < NB; ++k)
        if (k < nb) X[(size_t)(c0 + k) * Lp + i] = xr[s][k];
    }
  }
  __syncthreads();  // T's diagonal, ytv and vds of the last column
  if (warp == WARPS - 1) form_t(T, ytv, nb, lane);
  if (tid < nb) vd[tile * nblk * NB + c0 + tid] = vds[tid];
  __syncthreads();
  tm[(tile * nblk + b) * NB * NB + tid] = T[tid];
}

// ---------------------------------------------------------------------
// Block b's reflector applied to CW columns of a tile, inside its panel:
// X -= Y (T^T (Y^T X)) on a chunk of the columns c_lo .. c_hi (a tile's
// chunks adjacent in the grid), rows c0 .. Lp (rows above c0 are Y's
// zeros), in place.

struct Smem {
  union {
    uint16_t yb[3 * RT * YS];  // Y's bf16 parts, [part][row][k]
    float yf[RT * YF];         // the fp32 mode's Y, [row][k]
  };
  float m[CW * MS];          // the row tile of M, [column][row]
  float red[4 * NB * CW];    // pass 1's partials, [k-step][k][column]
  float p[NB * CW];          // Y^T M, [k][column]
  float t[NB * NB];          // the block's T
  union {
    uint16_t wb[3 * NB * WS];  // W's bf16 parts, [part][k][column]
    float wt[CW * NB];         // the fp32 mode's W^T, [column][k]
  };
};

// Y's rows r0 .. r0 + RT (global rows, r0 >= c0) into shared memory, split
// into the mode's parts, zero above each reflector's diagonal.
template <int CODE>
__device__ __forceinline__ void stage_y(Smem& s, const float* X,
                                        const float* vdb, int Lp, int c0,
                                        int nb, int r0, int tid) {
  const int row = tid % RT, i = r0 + row;
  auto yv = [&](int k) -> float {
    const int c = c0 + k;
    if (k >= nb || i < c || i >= Lp) return 0.f;
    return i == c ? vdb[k] : X[(size_t)c * Lp + i];
  };
  if constexpr (CODE == 0) {
#pragma unroll
    for (int h = 0; h < NB / 4; h += THREADS / RT) {
      const int k = 4 * (h + tid / RT);
      *reinterpret_cast<float4*>(s.yf + row * YF + k) =
          make_float4(yv(k), yv(k + 1), yv(k + 2), yv(k + 3));
    }
  } else {
#pragma unroll
    for (int h = 0; h < NB / 2; h += THREADS / RT) {
      const int k = 2 * (h + tid / RT);
      uint32_t o[3];
      split_pair<CODE>(yv(k), yv(k + 1), o);
#pragma unroll
      for (int q = 0; q < n_parts(CODE); ++q)
        *reinterpret_cast<uint32_t*>(s.yb + q * RT * YS + row * YS + k) = o[q];
    }
  }
}

// M's rows r0 .. r0 + RT of the CTA's columns into shared memory.
__device__ __forceinline__ void stage_m(Smem& s, const float* X, int Lp,
                                        int cs, int c_hi, int r0, int tid) {
  const int row = tid % RT, i = r0 + row;
#pragma unroll
  for (int c = tid / RT; c < CW; c += THREADS / RT) {
    const int col = cs + c;
    s.m[c * MS + row] = col < c_hi ? X[(size_t)col * Lp + i] : 0.f;
  }
}

template <int CODE>
__global__ void __launch_bounds__(THREADS, 2)
wide_apply_kernel(float* x, const float* __restrict__ vd,
                  const float* __restrict__ tm, int Lp, int n, int b,
                  int c_lo, int c_hi) {
  constexpr int NP = CODE <= 1 ? 1 : CODE, ORDER = NP - 1;
  __shared__ __align__(16) Smem s;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int nch = (c_hi - c_lo + CW - 1) / CW;  // a tile's chunks, adjacent
  const size_t tile = blockIdx.x / nch;
  const int nblk = (n + NB - 1) / NB, c0 = b * NB, nb = min(NB, n - c0);
  const int cs = c_lo + blockIdx.x % nch * CW;
  float* X = x + tile * n * Lp;
  const float* vdb = vd + tile * nblk * NB + c0;
  s.t[tid] = tm[(tile * nblk + b) * NB * NB + tid];  // THREADS == NB * NB
  // warp roles: pass 1 the 16 columns mt and the k-step ks of a row tile;
  // pass 2 the 16 columns mt and the 16 rows ks
  const int mt = warp & 1, ks = warp >> 1;

  // ---- pass 1: P = Y^T M over the rows c0 .. Lp ----
  float acc[2][3][4];  // [8-column half][order][fragment]
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int o = 0; o < 3; ++o)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][o][e] = 0.f;
  float d[4][NB];  // the fp32 mode's sums: 4 columns a warp, 16 k a lane
  if constexpr (CODE == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int k = 0; k < NB; ++k) d[c][k] = 0.f;
  }
  for (int r0 = c0; r0 < Lp; r0 += RT) {
    const int rows = min(RT, Lp - r0);  // a multiple of 16
    stage_y<CODE>(s, X, vdb, Lp, c0, nb, r0, tid);
    if (tid % RT < rows) stage_m(s, X, Lp, cs, c_hi, r0, tid);
    __syncthreads();
    if constexpr (CODE == 0) {
      for (int i = lane; i < rows; i += 32) {
        float y[NB];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v = reinterpret_cast<const float4*>(s.yf + i * YF)[q];
          y[4 * q] = v.x;
          y[4 * q + 1] = v.y;
          y[4 * q + 2] = v.z;
          y[4 * q + 3] = v.w;
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float mv = s.m[(4 * warp + c) * MS + i];
#pragma unroll
          for (int k = 0; k < NB; ++k) d[c][k] = fmaf(y[k], mv, d[c][k]);
        }
      }
    } else if (16 * ks < rows) {
      const int k0 = 16 * ks;
      const float* x0 = s.m + (mt * 16 + g) * MS + k0 + 2 * t;
      const float* x1 = x0 + 8 * MS;
      const float2 v[4] = {*reinterpret_cast<const float2*>(x0),
                           *reinterpret_cast<const float2*>(x1),
                           *reinterpret_cast<const float2*>(x0 + 8),
                           *reinterpret_cast<const float2*>(x1 + 8)};
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
        ldsm_x4_t(bf[q], s.yb + q * RT * YS +
                             (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * YS +
                             (lane >> 4) * 8);
#pragma unroll
      for (int j = 0; j < 2; ++j) mma_orders<NP>(acc[j], af, bf, j);
    }
    __syncthreads();
  }
  // the partials of the four k-steps (fp32: one warp's sums) into red,
  // then P in a fixed order
  if constexpr (CODE == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float sum = reduce16(d[c], lane);
      if (!(lane & 1)) s.p[sum_index(lane) * CW + 4 * warp + c] = sum;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = mt * 16 + g + (e >= 2 ? 8 : 0);
        const int k = j * 8 + 2 * t + (e & 1);
        s.red[(ks * NB + k) * CW + col] =
            sum_orders(acc[j][0][e], acc[j][1][e], acc[j][2][e], ORDER);
      }
    __syncthreads();
    for (int e = tid; e < NB * CW; e += THREADS)
      s.p[e] = __fadd_rn(__fadd_rn(s.red[e], s.red[NB * CW + e]),
                         __fadd_rn(s.red[2 * NB * CW + e],
                                   s.red[3 * NB * CW + e]));
  }
  __syncthreads();

  // ---- W = T^T P, float32, then split once ----
  for (int e = tid; e < NB * CW; e += THREADS) {
    const int k = e / CW, c = e % CW;
    float w = 0.f;
#pragma unroll
    for (int q = 0; q < NB; ++q)
      if (q <= k) w = fmaf(s.t[k * NB + q], s.p[q * CW + c], w);
    if (k >= nb) w = 0.f;
    if constexpr (CODE == 0) {
      s.wt[c * NB + k] = w;
    } else {
      float parts[3];
      split_parts(w, CODE, parts);
#pragma unroll
      for (int q = 0; q < NP; ++q)
        s.wb[q * NB * WS + k * WS + c] =
            __bfloat16_as_ushort(__float2bfloat16_rn(parts[q]));
    }
  }
  __syncthreads();

  // ---- pass 2: M -= Y W over the rows c0 .. Lp, in place ----
  uint32_t wf[3][4];  // W^T's A fragments of this warp's 16 columns
  if constexpr (CODE != 0) {
#pragma unroll
    for (int q = 0; q < NP; ++q)
      ldsm_x4_t(wf[q], s.wb + q * NB * WS +
                           ((lane & 7) + ((lane >> 4) & 1) * 8) * WS +
                           mt * 16 + ((lane >> 3) & 1) * 8);
  }
  for (int r0 = c0; r0 < Lp; r0 += RT) {
    const int rows = min(RT, Lp - r0);
    stage_y<CODE>(s, X, vdb, Lp, c0, nb, r0, tid);
    if (tid % RT < rows) stage_m(s, X, Lp, cs, c_hi, r0, tid);
    __syncthreads();
    if constexpr (CODE == 0) {
      const int row = tid % RT;
      if (row < rows) {
        float y[NB];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 v =
              reinterpret_cast<const float4*>(s.yf + row * YF)[q];
          y[4 * q] = v.x;
          y[4 * q + 1] = v.y;
          y[4 * q + 2] = v.z;
          y[4 * q + 3] = v.w;
        }
        for (int c = tid / RT; c < CW; c += THREADS / RT) {
          const float4* w = reinterpret_cast<const float4*>(s.wt + c * NB);
          float a = 0.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 v = w[q];
            a = fmaf(y[4 * q], v.x, a);
            a = fmaf(y[4 * q + 1], v.y, a);
            a = fmaf(y[4 * q + 2], v.z, a);
            a = fmaf(y[4 * q + 3], v.w, a);
          }
          float* mp = s.m + c * MS + row;
          *mp = __fsub_rn(*mp, a);
        }
      }
    } else if (16 * ks < rows) {
      const int i0 = 16 * ks;
      uint32_t bf[3][4];
#pragma unroll
      for (int q = 0; q < NP; ++q)
        ldsm_x4(bf[q], s.yb + q * RT * YS +
                           (i0 + (lane & 7) + ((lane >> 4) & 1) * 8) * YS +
                           ((lane >> 3) & 1) * 8);
      float u[3][2][4];
#pragma unroll
      for (int o = 0; o < 3; ++o)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) u[o][j][e] = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int o = 0; o <= ORDER; ++o)
#pragma unroll
          for (int v = 0; v < NP; ++v) {
            const int w = o - v;
            if (w >= 0 && w < NP)
              mma_bf16(u[o][j], wf[v], bf[w][2 * j], bf[w][2 * j + 1]);
          }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* mp = reinterpret_cast<float2*>(
              s.m + (mt * 16 + g + 8 * h) * MS + i0 + 8 * j + 2 * t);
          float2 y = *mp;
          y.x = __fsub_rn(y.x, sum_orders(u[0][j][2 * h], u[1][j][2 * h],
                                          u[2][j][2 * h], ORDER));
          y.y = __fsub_rn(y.y, sum_orders(u[0][j][2 * h + 1],
                                          u[1][j][2 * h + 1],
                                          u[2][j][2 * h + 1], ORDER));
          *mp = y;
        }
    }
    __syncthreads();
    {
      const int row = tid % RT, i = r0 + row;
      if (row < rows)
        for (int c = tid / RT; c < CW; c += THREADS / RT)
          if (cs + c < c_hi) X[(size_t)(cs + c) * Lp + i] = s.m[c * MS + row];
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------
// Panel p of every tile (columns c0 = 64 p .. c0 + wp): its reflectors Y
// to ys, split into the mode's parts, and, where form_t, its 64 x 64 T to
// t64 (by columns: T[q][p] at T[p PW + q]).  T merges the blocks' T a
// block b at a time: Z = (Y_{<b}^T Y_b) T_b, then T[:16b, b] =
// -T[:16b, :16b] Z, with Y_a^T Y_b summed over the rows in float32 FMAs.

struct PanelSmem {
  float y[PW * YT];      // a row tile of Y, float32, [k][row]
  float g[6 * NB * NB];  // Y_a^T Y_b for a < b, [b (b - 1) / 2 + a][p][q]
  float t[PW * PW];      // the merged T, by columns
  float z[3 * NB * NB];  // Z of a merge step, [row][column]
};

template <int CODE>
__global__ void __launch_bounds__(THREADS)
wide_panel_kernel(const float* __restrict__ x, const float* __restrict__ vd,
                  const float* __restrict__ tm, unsigned char* __restrict__ ys,
                  float* __restrict__ t64, int Lp, int n, int p, int form_t) {
  __shared__ __align__(16) PanelSmem s;
  const int tid = threadIdx.x;
  const size_t tile = blockIdx.x;
  const int nblk = (n + NB - 1) / NB, npan = (n + PW - 1) / PW;
  const int c0 = p * PW, wp = min(PW, n - c0), nsub = (wp + NB - 1) / NB;
  const float* X = x + tile * n * Lp;
  const float* vdt = vd + tile * nblk * NB;
  unsigned char* Yt = ys + tile * Lp * YS_ROW;
  // roles: staging a row and 16 of the k's; the Gram entry (gp, gq) of
  // each block pair
  const int row = tid % RT, kg = tid / RT, gp = tid / NB, gq = tid % NB;
  // this thread's 16 entries of Y's row r0 + row
  auto load = [&](float (&v)[NB], int r0) {
    const int i = r0 + row;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int c = c0 + NB * kg + k;
      v[k] = (i >= Lp || NB * kg + k >= wp || i < c) ? 0.f
             : i == c                               ? vdt[c]
                                                    : X[(size_t)c * Lp + i];
    }
  };
  float gacc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float v[NB], vn[NB];
  load(v, c0);
  for (int r0 = c0; r0 < Lp; r0 += RT) {
    const int i = r0 + row;
    if (i < Lp) {
      if (form_t) {
#pragma unroll
        for (int k = 0; k < NB; ++k) s.y[(NB * kg + k) * YT + row] = v[k];
      }
      if constexpr (CODE == 0) {
        float4* dst = reinterpret_cast<float4*>(Yt + ((size_t)i * PW + NB * kg) * 4);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2],
                               v[4 * q + 3]);
      } else {
        uint32_t o[NB / 2][3];
#pragma unroll
        for (int h = 0; h < NB / 2; ++h)
          split_pair<CODE>(v[2 * h], v[2 * h + 1], o[h]);
#pragma unroll
        for (int q = 0; q < n_parts(CODE); ++q) {
          uint4* dst = reinterpret_cast<uint4*>(
              Yt + (((size_t)q * Lp + i) * PW + NB * kg) * 2);
          dst[0] = make_uint4(o[0][q], o[1][q], o[2][q], o[3][q]);
          dst[1] = make_uint4(o[4][q], o[5][q], o[6][q], o[7][q]);
        }
      }
    }
    load(vn, r0 + RT);  // the next row tile's, in flight over the Gram
    if (form_t) {       // the same for every thread
      __syncthreads();
      const int rows = min(RT, Lp - r0);  // a multiple of 16
      for (int r = 0; r < rows; r += 4) {
        float4 ya[3], yb[3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
          ya[a] = *reinterpret_cast<const float4*>(s.y + (NB * a + gp) * YT + r);
#pragma unroll
        for (int b = 1; b < 4; ++b)
          yb[b - 1] =
              *reinterpret_cast<const float4*>(s.y + (NB * b + gq) * YT + r);
#pragma unroll
        for (int b = 1; b < 4; ++b)
#pragma unroll
          for (int a = 0; a < b; ++a)
            if (b < nsub) {
              float& g = gacc[b * (b - 1) / 2 + a];
              g = fmaf(ya[a].x, yb[b - 1].x, g);
              g = fmaf(ya[a].y, yb[b - 1].y, g);
              g = fmaf(ya[a].z, yb[b - 1].z, g);
              g = fmaf(ya[a].w, yb[b - 1].w, g);
            }
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < NB; ++k) v[k] = vn[k];
  }
  if (!form_t) return;
  // the blocks' T on the diagonal (T past a block's columns is 0)
  for (int e = tid; e < PW * PW; e += THREADS) {
    const int pc = e / PW, q = e % PW, a = pc / NB;
    s.t[e] = (q / NB == a && a < nsub)
                 ? tm[((tile * nblk + p * 4 + a) * NB + pc % NB) * NB + q % NB]
                 : 0.f;
  }
#pragma unroll
  for (int e = 0; e < 6; ++e) s.g[e * NB * NB + tid] = gacc[e];
  __syncthreads();
  for (int b = 1; b < nsub; ++b) {
    const float* tb = s.t + NB * b * PW + NB * b;  // T_b(q, c) at tb[c PW + q]
    for (int e = tid; e < NB * b * NB; e += THREADS) {
      const int r = e / NB, c = e % NB;
      const float* gr = s.g + (b * (b - 1) / 2 + r / NB) * NB * NB +
                        (r % NB) * NB;  // Y_r^T Y_{16 b + q} at gr[q]
      float z = 0.f;
      for (int q = 0; q <= c; ++q) z = fmaf(gr[q], tb[c * PW + q], z);
      s.z[r * NB + c] = z;
    }
    __syncthreads();
    for (int e = tid; e < NB * b * NB; e += THREADS) {
      const int r = e / NB, c = e % NB;
      float v = 0.f;
      for (int q = r; q < NB * b; ++q)
        v = fmaf(s.t[q * PW + r], s.z[q * NB + c], v);
      s.t[(NB * b + c) * PW + r] = -v;
    }
    __syncthreads();
  }
  for (int e = tid; e < PW * PW; e += THREADS)
    t64[(tile * npan + p) * PW * PW + e] = s.t[e];
}

// ---------------------------------------------------------------------
// Panel p applied to CW columns of a tile: M -= Y (T^T (Y^T M)) (TRANS,
// the trailing update of X) or M -= Y (T (Y^T M)) (the Q build).  M's
// columns cs .. cs + CW, a chunk of c_lo .. n, are read from src (stride
// Lp) and written to dst (stride dst_ld, rows < dst_ld); a column in
// [c0, gen_hi) is not read but generated as e_c (I_thin's), and its rows
// above c0 are written as 0; columns past n are neither read nor written.
// Rows below c0 are Y's zeros and are not touched.

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// Byte offsets of wide_outer_kernel's dynamic shared memory for a chunk
// of `rows` rows: M's columns (stride ms floats, 8 mod 32), the ring of
// two Y slots, over which pass 1's partials and T lie once pass 1 is
// done, P, and W's parts (the fp32 mode: W^T).
struct OuterLayout {
  int ms, slot, ring, red, t, p, w, bytes;
};

__host__ __device__ inline OuterLayout outer_layout(int rows, int code) {
  const int np = code <= 1 ? 1 : code;
  OuterLayout o;
  o.ms = (rows + 31) / 32 * 32 + 8;
  o.slot = code == 0 ? RT * YPF * 4 : np * RT * YP * 2;
  o.ring = CW * o.ms * 4;
  const int red = code == 0 ? 0 : 2 * PW * CW * 4;
  o.red = o.ring;
  o.t = o.ring + red;
  const int over = red + PW * PW * 4;
  o.p = o.ring + (2 * o.slot > over ? 2 * o.slot : over);
  o.w = o.p + PW * CW * 4;
  o.bytes = o.w + (code == 0 ? CW * WPF * 4 : np * PW * WS * 2);
  return o;
}

template <int CODE, bool TRANS>
__global__ void __launch_bounds__(THREADS, 2)
wide_outer_kernel(const unsigned char* __restrict__ ys,
                  const float* __restrict__ t64, const float* src, float* dst,
                  int dst_ld, int Lp, int n, int p, int c_lo, int gen_hi) {
  constexpr int NP = CODE <= 1 ? 1 : CODE, ORDER = NP - 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int c0 = p * PW, wp = min(PW, n - c0), R = Lp - c0;
  const OuterLayout lay = outer_layout(R, CODE);
  const int ms = lay.ms;
  float* m = reinterpret_cast<float*>(smem);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  float* ts = reinterpret_cast<float*>(smem + lay.t);
  float* ps = reinterpret_cast<float*>(smem + lay.p);
  uint16_t* wb = reinterpret_cast<uint16_t*>(smem + lay.w);
  float* wt = reinterpret_cast<float*>(smem + lay.w);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int nch = (n - c_lo + CW - 1) / CW;  // a tile's chunks, adjacent
  const size_t tile = blockIdx.x / nch;
  const int npan = (n + PW - 1) / PW, ntl = (R + RT - 1) / RT;
  const int cs = c_lo + blockIdx.x % nch * CW;
  const unsigned char* Yt = ys + tile * Lp * YS_ROW;
  src += tile * n * Lp;
  dst += tile * n * dst_ld;

  // Row tile l: Y's rows into slot l % 2 and, with_m, M's rows into m
  // (the generated and absent columns stored directly); one commit group.
  auto fetch = [&](int l, bool with_m) {
    const int r0 = l * RT, rows = min(RT, R - r0);
    unsigned char* slot = smem + lay.ring + (l & 1) * lay.slot;
    if constexpr (CODE == 0) {
      for (int e = tid; e < RT * PW / 4; e += THREADS) {
        const int r = e / (PW / 4), ch = e % (PW / 4);
        if (r < rows)
          cp_async16(slot + (r * YPF + 4 * ch) * 4,
                     Yt + ((size_t)(c0 + r0 + r) * PW + 4 * ch) * 4);
      }
    } else {
      for (int e = tid; e < NP * RT * PW / 8; e += THREADS) {
        const int q = e / (RT * PW / 8), r = e / (PW / 8) % RT,
                  ch = e % (PW / 8);
        if (r < rows)
          cp_async16(slot + ((q * RT + r) * YP + 8 * ch) * 2,
                     Yt + (((size_t)q * Lp + c0 + r0 + r) * PW + 8 * ch) * 2);
      }
    }
    if (with_m) {
      for (int e = tid; e < CW * RT / 4; e += THREADS) {
        const int c = e / (RT / 4), r = r0 + e % (RT / 4) * 4,
                  col = cs + c;
        if (r >= r0 + rows) continue;
        float* d = m + c * ms + r;
        if (col >= c0 && col < gen_hi) {
          const int i = c0 + r;
          *reinterpret_cast<float4*>(d) =
              make_float4(i == col, i + 1 == col, i + 2 == col, i + 3 == col);
        } else if (col < n) {
          cp_async16(d, src + (size_t)col * Lp + c0 + r);
        } else {
          *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
        }
      }
    }
    cp_commit();
  };

  // ---- pass 1: P = Y^T M over the rows c0 .. Lp, M kept ----
  // warp roles: the 16 columns mt, the 32 k's kh, and of each row tile the
  // rows 32 kp .. 32 kp + 32 (the fp32 mode: column c, the 8 k's kq)
  const int mt = warp & 1, kh = (warp >> 1) & 1, kp = warp >> 2;
  float acc[4][3][4];  // [8-k group][order][fragment]
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int o = 0; o < 3; ++o)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][o][e] = 0.f;
  float d[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int fc = warp * 4 + (lane & 3), kq = lane >> 2;  // the fp32 roles
  // A chunk of the Q build's own panel columns (each in [c0, gen_hi) or
  // past n) is I_thin's: P = Y^T e_c is Y's row c at the mode (its parts
  // summed as pass 1 sums their products with e_c's parts 1, 0, 0), read
  // from ys, and pass 1 is left out.
  const bool gen = cs < gen_hi;
  if (gen) {
    for (int e = tid; e < CW * R / 4; e += THREADS) {
      const int c = e / (R / 4), r = e % (R / 4) * 4, i = c0 + r,
                col = cs + c < gen_hi ? cs + c : -1;
      *reinterpret_cast<float4*>(m + c * ms + r) =
          make_float4(i == col, i + 1 == col, i + 2 == col, i + 3 == col);
    }
    for (int e = tid; e < PW * CW; e += THREADS) {
      const int k = e / CW, col = cs + e % CW;
      float v = 0.f;
      if (col < gen_hi) {
        if constexpr (CODE == 0) {
          v = reinterpret_cast<const float*>(Yt)[(size_t)col * PW + k];
        } else {
          const __nv_bfloat16* yb = reinterpret_cast<const __nv_bfloat16*>(Yt);
          float y[3] = {0.f, 0.f, 0.f};
#pragma unroll
          for (int q = 0; q < NP; ++q)
            y[q] = __bfloat162float(yb[((size_t)q * Lp + col) * PW + k]);
          v = sum_orders(y[0], y[1], y[2], ORDER);
        }
      }
      ps[e] = v;
    }
  } else {
    fetch(0, true);
    for (int l = 0; l < ntl; ++l) {
      if (l + 1 < ntl) {
        fetch(l + 1, true);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const int rows = min(RT, R - l * RT);  // a multiple of 16
      const unsigned char* slot = smem + lay.ring + (l & 1) * lay.slot;
      if constexpr (CODE == 0) {
        const float* yf = reinterpret_cast<const float*>(slot);
        for (int r = 0; r < rows; r += 4) {
          const float4 mv =
              *reinterpret_cast<const float4*>(m + fc * ms + l * RT + r);
          const float mr[4] = {mv.x, mv.y, mv.z, mv.w};
  #pragma unroll
          for (int h = 0; h < 4; ++h) {
            const float4* yr =
                reinterpret_cast<const float4*>(yf + (r + h) * YPF + 8 * kq);
            const float4 y0 = yr[0], y1 = yr[1];
            d[0] = fmaf(y0.x, mr[h], d[0]);
            d[1] = fmaf(y0.y, mr[h], d[1]);
            d[2] = fmaf(y0.z, mr[h], d[2]);
            d[3] = fmaf(y0.w, mr[h], d[3]);
            d[4] = fmaf(y1.x, mr[h], d[4]);
            d[5] = fmaf(y1.y, mr[h], d[5]);
            d[6] = fmaf(y1.z, mr[h], d[6]);
            d[7] = fmaf(y1.w, mr[h], d[7]);
          }
        }
      } else {
        const uint16_t* yb = reinterpret_cast<const uint16_t*>(slot);
  #pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k0 = 32 * kp + 16 * h;
          if (k0 < rows) {
            const float* x0 = m + (mt * 16 + g) * ms + l * RT + k0 + 2 * t;
            const float* x1 = x0 + 8 * ms;
            const float2 v[4] = {*reinterpret_cast<const float2*>(x0),
                                 *reinterpret_cast<const float2*>(x1),
                                 *reinterpret_cast<const float2*>(x0 + 8),
                                 *reinterpret_cast<const float2*>(x1 + 8)};
            uint32_t af[3][4], bf[3][4];
  #pragma unroll
            for (int f = 0; f < 4; ++f) {
              uint32_t o[3];
              split_pair<CODE>(v[f].x, v[f].y, o);
  #pragma unroll
              for (int q = 0; q < NP; ++q) af[q][f] = o[q];
            }
  #pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
  #pragma unroll
              for (int q = 0; q < NP; ++q)
                ldsm_x4_t(bf[q], yb + q * RT * YP +
                                     (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                         YP +
                                     32 * kh + 16 * kk + (lane >> 4) * 8);
  #pragma unroll
              for (int j = 0; j < 2; ++j)
                mma_orders<NP>(acc[2 * kk + j], af, bf, j);
            }
          }
        }
      }
      __syncthreads();
    }
    // pass 1's partials of the two row halves into red (over the ring: every
    // copy has landed)
    if constexpr (CODE == 0) {
  #pragma unroll
      for (int j = 0; j < 8; ++j) ps[(8 * kq + j) * CW + fc] = d[j];
    } else {
  #pragma unroll
      for (int j = 0; j < 4; ++j)
  #pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = mt * 16 + g + (e >= 2 ? 8 : 0);
          const int k = 32 * kh + 8 * j + 2 * t + (e & 1);
          red[(kp * PW + k) * CW + col] =
              sum_orders(acc[j][0][e], acc[j][1][e], acc[j][2][e], ORDER);
        }
    }
  }
  for (int e = tid; e < PW * PW; e += THREADS)
    ts[e] = t64[(tile * npan + p) * PW * PW + e];
  __syncthreads();
  if (CODE != 0 && !gen) {  // P in a fixed order
    for (int e = tid; e < PW * CW; e += THREADS)
      ps[e] = __fadd_rn(red[e], red[PW * CW + e]);
    __syncthreads();
  }

  // ---- W = T^T P (TRANS) or T P, float32, then split once ----
  for (int e = tid; e < PW * CW; e += THREADS) {
    const int k = e / CW, c = e % CW;
    float w = 0.f;
    if (k < wp) {
      if (TRANS)
        for (int q = 0; q <= k; ++q) w = fmaf(ts[k * PW + q], ps[q * CW + c], w);
      else
        for (int q = k; q < PW; ++q) w = fmaf(ts[q * PW + k], ps[q * CW + c], w);
    }
    if constexpr (CODE == 0) {
      wt[c * WPF + k] = w;
    } else {
      float parts[3];
      split_parts(w, CODE, parts);
#pragma unroll
      for (int q = 0; q < NP; ++q)
        wb[(q * PW + k) * WS + c] =
            __bfloat16_as_ushort(__float2bfloat16_rn(parts[q]));
    }
  }
  __syncthreads();

  // ---- pass 2: M -= Y W over the rows c0 .. Lp, written to dst ----
  // warp roles: the 16 columns mt and the 16 rows ks of a row tile (the
  // fp32 mode: column fc, the rows kq + 8 h)
  const int ks = warp >> 1;
  uint32_t wf[3][4][4];  // W^T's A fragments: [part][k-step][fragment]
  float wr[PW];          // the fp32 mode's column fc of W
  if constexpr (CODE == 0) {
#pragma unroll
    for (int k = 0; k < PW; ++k) wr[k] = wt[fc * WPF + k];
  } else {
#pragma unroll
    for (int q = 0; q < NP; ++q)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        ldsm_x4_t(wf[q][kk],
                  wb + (q * PW + 16 * kk + (lane & 7) +
                        ((lane >> 4) & 1) * 8) * WS +
                      mt * 16 + ((lane >> 3) & 1) * 8);
  }
  fetch(0, false);
  for (int l = 0; l < ntl; ++l) {
    if (l + 1 < ntl) {
      fetch(l + 1, false);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int rows = min(RT, R - l * RT);
    const unsigned char* slot = smem + lay.ring + (l & 1) * lay.slot;
    if constexpr (CODE == 0) {
      const float* yf = reinterpret_cast<const float*>(slot);
#pragma unroll
      for (int h = 0; h < 8; ++h) {
        const int r = kq + 8 * h;
        if (r < rows) {
          const float4* yr = reinterpret_cast<const float4*>(yf + r * YPF);
          float a = 0.f;
#pragma unroll
          for (int q = 0; q < PW / 4; ++q) {
            const float4 y = yr[q];
            a = fmaf(y.x, wr[4 * q], a);
            a = fmaf(y.y, wr[4 * q + 1], a);
            a = fmaf(y.z, wr[4 * q + 2], a);
            a = fmaf(y.w, wr[4 * q + 3], a);
          }
          float* mp = m + fc * ms + l * RT + r;
          *mp = __fsub_rn(*mp, a);
        }
      }
    } else if (16 * ks < rows) {
      const uint16_t* yb = reinterpret_cast<const uint16_t*>(slot);
      const int i0 = 16 * ks;
      float u[3][2][4];
#pragma unroll
      for (int o = 0; o < 3; ++o)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) u[o][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t bf[3][4];
#pragma unroll
        for (int q = 0; q < NP; ++q)
          ldsm_x4(bf[q], yb + (q * RT + i0 + (lane & 7) +
                               ((lane >> 4) & 1) * 8) * YP +
                             16 * kk + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float c0f[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(c0f, wf[0][kk], bf[0][2 * j], bf[0][2 * j + 1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) u[0][j][e] = __fadd_rn(u[0][j][e], c0f[e]);
#pragma unroll
          for (int o = 1; o <= ORDER; ++o)
#pragma unroll
            for (int v = 0; v < NP; ++v) {
              const int w = o - v;
              if (w >= 0 && w < NP)
                mma_bf16(u[o][j], wf[v][kk], bf[w][2 * j], bf[w][2 * j + 1]);
            }
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* mp = reinterpret_cast<float2*>(
              m + (mt * 16 + g + 8 * h) * ms + l * RT + i0 + 8 * j + 2 * t);
          float2 y = *mp;
          y.x = __fsub_rn(y.x, sum_orders(u[0][j][2 * h], u[1][j][2 * h],
                                          u[2][j][2 * h], ORDER));
          y.y = __fsub_rn(y.y, sum_orders(u[0][j][2 * h + 1],
                                          u[1][j][2 * h + 1],
                                          u[2][j][2 * h + 1], ORDER));
          *mp = y;
        }
    }
    __syncthreads();
    // the row tile out; the next tile's products touch other rows of m
    {
      const int row = tid % RT, i = c0 + l * RT + row;
      if (row < rows && i < dst_ld)
        for (int c = tid / RT; c < CW; c += THREADS / RT)
          if (cs + c < n)
            dst[(size_t)(cs + c) * dst_ld + i] = m[c * ms + l * RT + row];
    }
  }
  // the generated columns' rows above the panel: I_thin's zeros
  for (int c = 0; c < CW; ++c) {
    const int col = cs + c;
    if (col >= c0 && col < gen_hi && col < n)
      for (int i = tid; i < c0 && i < dst_ld; i += THREADS)
        dst[(size_t)col * dst_ld + i] = 0.f;
  }
}

// ---------------------------------------------------------------------

static int factor(int rpt, float* x, float* vd, float* tm, int batch, int Lp,
                  int n, int b, cudaStream_t s) {
  if (rpt == 1)
    wide_factor_kernel<1><<<batch, THREADS, 0, s>>>(x, vd, tm, Lp, n, b);
  else if (rpt == 2)
    wide_factor_kernel<2><<<batch, THREADS, 0, s>>>(x, vd, tm, Lp, n, b);
  else
    wide_factor_kernel<4><<<batch, THREADS, 0, s>>>(x, vd, tm, Lp, n, b);
  return (int)cudaGetLastError();
}

template <int CODE, bool TRANS>
static int outer(const unsigned char* ys, const float* t64, const float* src,
                 float* dst, int dst_ld, int batch, int Lp, int n, int p,
                 int c_lo, int gen_hi, cudaStream_t s) {
  const int bytes = outer_layout(Lp - p * PW, CODE).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      wide_outer_kernel<CODE, TRANS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  wide_outer_kernel<CODE, TRANS>
      <<<(n - c_lo + CW - 1) / CW * batch, THREADS, bytes, s>>>(
          ys, t64, src, dst, dst_ld, Lp, n, p, c_lo, gen_hi);
  return (int)cudaGetLastError();
}

static inline int rows_padded(int L) {
  return (L + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
}

// The launch sequence of one call at mode code CODE (panel_wide_launch).
// issued[0] counts the kernels it launches, issued[1] the wide applies
// among them.
template <int CODE>
static int launch(const float* a, float* qt, float* r, float* x, float* qw,
                  float* vd, float* tm, unsigned char* ys, float* t64,
                  int batch, int L, int n, int* issued, cudaStream_t s) {
  const int Lp = rows_padded(L), npan = (n + PW - 1) / PW;
  const int rpt = Lp <= THREADS ? 1 : (Lp <= 2 * THREADS ? 2 : 4);
  int err;
  issued[0] = issued[1] = 0;
  wide_load_kernel<<<dim3(batch, (n + 31) / 32), THREADS, 0, s>>>(a, x, L,
                                                                  Lp, n);
  if ((err = (int)cudaGetLastError())) return err;
  ++issued[0];
  for (int p = 0; p < npan; ++p) {
    const int c_end = p * PW + PW < n ? p * PW + PW : n;
    for (int b = p * PW / NB; b * NB < c_end; ++b) {
      if ((err = factor(rpt, x, vd, tm, batch, Lp, n, b, s))) return err;
      ++issued[0];
      const int c_rest = b * NB + NB;
      if (c_rest < c_end) {
        wide_apply_kernel<CODE><<<(c_end - c_rest + CW - 1) / CW * batch,
                                  THREADS, 0, s>>>(x, vd, tm, Lp, n, b,
                                                   c_rest, c_end);
        if ((err = (int)cudaGetLastError())) return err;
        ++issued[0];
      }
    }
    if (c_end < n) {
      wide_panel_kernel<CODE><<<batch, THREADS, 0, s>>>(x, vd, tm, ys, t64,
                                                         Lp, n, p, 1);
      if ((err = (int)cudaGetLastError()) ||
          (err = outer<CODE, true>(ys, t64, x, x, Lp, batch, Lp, n, p, c_end,
                                   p * PW, s)))
        return err;
      issued[0] += 2;
      ++issued[1];
    }
  }
  wide_r_kernel<<<batch, THREADS, 0, s>>>(x, r, Lp, n);
  if ((err = (int)cudaGetLastError())) return err;
  ++issued[0];
  for (int p = npan - 1; p >= 0; --p) {
    const int c0 = p * PW;
    wide_panel_kernel<CODE><<<batch, THREADS, 0, s>>>(x, vd, tm, ys, t64, Lp,
                                                       n, p, p == npan - 1);
    if ((err = (int)cudaGetLastError()) ||
        (err = outer<CODE, false>(ys, t64, qw, p == 0 ? qt : qw,
                                  p == 0 ? L : Lp, batch, Lp, n, p, c0,
                                  c0 + PW < n ? c0 + PW : n, s)))
      return err;
    issued[0] += 2;
    ++issued[1];
  }
  return 0;
}

extern "C" {

int panel_wide_n_max(void) { return N_WIDE_MAX; }
int panel_wide_l_max(void) { return L_WIDE_MAX; }
int panel_wide_block(void) { return NB; }
int panel_wide_panel(void) { return PW; }
int panel_wide_row_pad(void) { return ROW_PAD; }
int panel_wide_ys_row_bytes(void) { return YS_ROW; }

// Factor a (batch, L, n) float32 batch into qt (batch, n, L) and r
// (batch, n, n); code is the mode code of splits.cuh.  Scratch from the
// caller: x (batch, n, Lp) and qw (batch, n, Lp) float32 (qw may be qt
// when Lp == L), vd (batch, nblk 16) and tm (batch, nblk, 16, 16), ys
// (batch, Lp, YS_ROW bytes) and t64 (batch, npan, 64, 64) float32,
// Lp = round_up(L, 16), nblk = ceil(n / 16), npan = ceil(n / 64).
// issued[0] gets the kernels launched, issued[1] the wide applies among
// them, as far as the sequence got.
int panel_wide_launch(const float* a, float* qt, float* r, float* x,
                      float* qw, float* vd, float* tm, void* ys, float* t64,
                      int batch, int L, int n, int code, int* issued,
                      void* stream) {
  if (n < 1 || n > N_WIDE_MAX || L < n || L > L_WIDE_MAX || batch < 1 ||
      code < 0 || code > 3 || (rows_padded(L) != L && qw == qt))
    return (int)cudaErrorInvalidValue;
  auto run = code == 0 ? launch<0> : code == 1 ? launch<1>
                                   : code == 2 ? launch<2> : launch<3>;
  return run(a, qt, r, x, qw, vd, tm, static_cast<unsigned char*>(ys), t64,
             batch, L, n, issued, (cudaStream_t)stream);
}

}  // extern "C"
