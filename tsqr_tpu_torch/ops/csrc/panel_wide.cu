// Batched Householder QR of wide (L, n) tiles, 128 < n <= 512: A (B, L, n)
// float32 -> Q^T (B, n, L) and R (B, n, n), the tile in device memory
// and one 16-column block at a time on chip.
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
// The function is panel_qr.cu's and B3's: LAPACK's geqrf + orgqr blocked
// by NB = 16 columns in compact WY (Y, T): R_jj = -sign(x_j) ||x|| with
// sign(0) = +1, v = x + sign(x_j) ||x|| e_j over rows >= j, beta =
// 2 / ||v||^2 or 0 where ||v||^2 <= 1e-30 (a zero column passes through as
// H = I); the trailing update X -= Y (T^T (Y^T X)) and, from the right,
// the Q build Q -= Y (T (Y^T Q)) run at the mode; the small T products
// are float32.  Zero rows below every pivot stay zero in every reflector,
// so their Q rows come out exactly 0 (the tree pads with them).
//
// What bounds it on this card: at (4096, 256, 256) bf16x6_cor (the
// (2^20, 256) tree's leaves) one read of A and the writes of Q^T and R
// are 2.1 GB (0.64 ms at 3.35 TB/s); the ~4 L n^2 - 4 n^3 / 3 flops a
// tile are, at six split products, 1.1 TFLOP (1.1 ms on the tensor
// cores).  What bounds this design is the traffic of its per-block
// launches and the serial column chain.  The design, simple first:
// * The work tile X (B, n, Lp) is A transposed, column-major, rows
//   padded with zeros to Lp = round_up(L, 16) (wide_load_kernel).  It
//   ends holding R above the diagonal and the reflectors below it, as in
//   geqrf; each reflector's diagonal entry goes to vd, each block's T to
//   tm.
// * Per block of 16 columns, two launches.  wide_factor_kernel, a CTA a
//   tile, runs the block's column chain as panel_qr.cu does (each thread
//   its RPT <= 4 rows of the block's columns in registers, rotated so the
//   current column is register 0, one barrier a column) and writes the
//   block back with vd and T.  wide_apply_kernel, a CTA a (tile, chunk
//   of CW = 32 columns), applies the block reflector to its columns in
//   two passes over 64-row tiles staged in shared memory: P = Y^T X
//   (pass 1, a warp a 16-column by 16-row unit, the units' partials
//   summed in a fixed order), W = T^T P in float32, split once, then
//   X -= Y W (pass 2).  X's columns are read twice and written once a
//   block; nothing larger than a row tile is on chip.
// * The Q build runs the same apply kernel over the blocks from the
//   right, Q -= Y (T (Y^T Q)) into Q^T's layout, the block's own columns
//   generated as those of I_thin.  3 n / 16 + 1 launches a call: 49 at
//   n = 256, 97 at n = 512.
// * The block products run on mma.sync m16n8k16 over the mode's bf16
//   parts (splits.cuh), each residual order in its own float32 fragment,
//   orders added smallest first; order 0 joins its sum by a rounded add a
//   k-step (the tensor core's own float32 accumulation drifted 1.2e-6
//   from the plain version over long sums in stream_wide.cu).  The fp32
//   mode must not round its operands: its products are float32 FMAs.
// * Kept out for now: the tile resident across blocks (a cluster's
//   distributed shared memory holds 8 x 227 KB, not the 2 MiB of a
//   (1024, 512) tile), wgmma, and the cp.async ring of stream_wide.cu.

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
#define CW 32              // columns of an apply CTA
#define RT 64              // rows of a staged row tile
#define MS (RT + 8)        // float32 stride of a staged column (8 mod 32)
#define YS 24              // bf16 a row of a staged Y part (conflict-free)
#define YF 20              // float32 a row of staged Y in the fp32 mode
#define WS (CW + 8)        // bf16 a row of a W part
#define FULL 0xffffffffu

static_assert(THREADS == NB * NB, "a thread an entry of T");
static_assert(THREADS == 4 * RT && CW == 4 * WARPS, "the warp roles");

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
// The block reflector of block b applied to CW columns of a tile:
// M -= Y (T^T (Y^T M)) (TRANS, the trailing update of X) or
// M -= Y (T (Y^T M)) (the Q build).  M's columns c_lo + CW blockIdx.y ..
// are read from src (row stride src_ld) and written to dst (stride
// dst_ld, rows < dst_rows); a column in [gen_lo, gen_hi) is not read but
// generated as e_c (I_thin's), and its rows above c0 are written as 0.
// Rows below c0 are Y's zeros and are neither read nor written.

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
__device__ __forceinline__ void stage_m(Smem& s, const float* src,
                                        int src_ld, int n, int cs,
                                        int gen_lo, int gen_hi, int r0,
                                        int tid) {
  const int row = tid % RT, i = r0 + row;
#pragma unroll
  for (int c = tid / RT; c < CW; c += THREADS / RT) {
    const int col = cs + c;
    float v = 0.f;
    if (col >= gen_lo && col < gen_hi)
      v = i == col ? 1.f : 0.f;
    else if (col < n)
      v = src[(size_t)col * src_ld + i];
    s.m[c * MS + row] = v;
  }
}

template <int CODE, bool TRANS>
__global__ void __launch_bounds__(THREADS, 2)
wide_apply_kernel(const float* x, const float* __restrict__ vd,
                  const float* __restrict__ tm, const float* src, int src_ld,
                  float* dst, int dst_ld, int dst_rows, int Lp, int n, int b,
                  int c_lo, int gen_lo, int gen_hi) {
  constexpr int NP = CODE <= 1 ? 1 : CODE, ORDER = NP - 1;
  __shared__ __align__(16) Smem s;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t tile = blockIdx.x;
  const int nblk = (n + NB - 1) / NB, c0 = b * NB, nb = min(NB, n - c0);
  const int cs = c_lo + blockIdx.y * CW;
  const float* X = x + tile * n * Lp;
  const float* vdb = vd + tile * nblk * NB + c0;
  src += tile * n * src_ld;
  dst += tile * n * dst_ld;
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
    if (tid % RT < rows)
      stage_m(s, src, src_ld, n, cs, gen_lo, gen_hi, r0, tid);
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

  // ---- W = T^T P (TRANS) or T P, float32, then split once ----
  for (int e = tid; e < NB * CW; e += THREADS) {
    const int k = e / CW, c = e % CW;
    float w = 0.f;
#pragma unroll
    for (int q = 0; q < NB; ++q)
      if (TRANS ? q <= k : q >= k)
        w = fmaf(TRANS ? s.t[k * NB + q] : s.t[q * NB + k], s.p[q * CW + c],
                 w);
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

  // ---- pass 2: M -= Y W over the rows c0 .. Lp, written to dst ----
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
    if (tid % RT < rows)
      stage_m(s, src, src_ld, n, cs, gen_lo, gen_hi, r0, tid);
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
      if (row < rows && i < dst_rows)
        for (int c = tid / RT; c < CW; c += THREADS / RT)
          if (cs + c < n)
            dst[(size_t)(cs + c) * dst_ld + i] = s.m[c * MS + row];
    }
    __syncthreads();
  }
  // the generated columns' rows above the block: I_thin's zeros
  for (int c = 0; c < CW; ++c) {
    const int col = cs + c;
    if (col >= gen_lo && col < gen_hi && col < n)
      for (int i = tid; i < c0 && i < dst_rows; i += THREADS)
        dst[(size_t)col * dst_ld + i] = 0.f;
  }
}

// ---------------------------------------------------------------------

template <int CODE>
static int apply(bool trans, const float* x, const float* vd,
                 const float* tm, const float* src, int src_ld, float* dst,
                 int dst_ld, int dst_rows, int batch, int Lp, int n, int b,
                 int c_lo, int gen_lo, int gen_hi, cudaStream_t s) {
  const dim3 grid(batch, (n - c_lo + CW - 1) / CW);
  if (trans)
    wide_apply_kernel<CODE, true><<<grid, THREADS, 0, s>>>(
        x, vd, tm, src, src_ld, dst, dst_ld, dst_rows, Lp, n, b, c_lo, gen_lo,
        gen_hi);
  else
    wide_apply_kernel<CODE, false><<<grid, THREADS, 0, s>>>(
        x, vd, tm, src, src_ld, dst, dst_ld, dst_rows, Lp, n, b, c_lo, gen_lo,
        gen_hi);
  return (int)cudaGetLastError();
}

static int apply_code(int code, bool trans, const float* x, const float* vd,
                      const float* tm, const float* src, int src_ld,
                      float* dst, int dst_ld, int dst_rows, int batch, int Lp,
                      int n, int b, int c_lo, int gen_lo, int gen_hi,
                      cudaStream_t s) {
  auto f = code == 0 ? apply<0> : code == 1 ? apply<1>
                                  : code == 2 ? apply<2> : apply<3>;
  return f(trans, x, vd, tm, src, src_ld, dst, dst_ld, dst_rows, batch, Lp,
           n, b, c_lo, gen_lo, gen_hi, s);
}

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

static inline int rows_padded(int L) {
  return (L + ROW_PAD - 1) / ROW_PAD * ROW_PAD;
}

extern "C" {

int panel_wide_n_max(void) { return N_WIDE_MAX; }
int panel_wide_l_max(void) { return L_WIDE_MAX; }
int panel_wide_block(void) { return NB; }
int panel_wide_row_pad(void) { return ROW_PAD; }

// Kernel launches of one call at width n.
int panel_wide_kernel_launches(int n) {
  const int nblk = (n + NB - 1) / NB;
  return 2 + nblk + (nblk - 1) + nblk;
}

// Factor a (batch, L, n) float32 batch into qt (batch, n, L) and r
// (batch, n, n); code is the mode code of splits.cuh.  Scratch from the
// caller: x (batch, n, Lp) and qw (batch, n, Lp) float32 (qw may be qt
// when Lp == L), vd (batch, nblk 16) and tm (batch, nblk, 16, 16)
// float32, Lp = round_up(L, 16), nblk = ceil(n / 16).
int panel_wide_launch(const float* a, float* qt, float* r, float* x,
                      float* qw, float* vd, float* tm, int batch, int L,
                      int n, int code, void* stream) {
  if (n < 1 || n > N_WIDE_MAX || L < n || L > L_WIDE_MAX || batch < 1 ||
      code < 0 || code > 3)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int Lp = rows_padded(L), nblk = (n + NB - 1) / NB;
  if (Lp != L && qw == qt) return (int)cudaErrorInvalidValue;
  const int rpt = Lp <= THREADS ? 1 : (Lp <= 2 * THREADS ? 2 : 4);
  int err;
  wide_load_kernel<<<dim3(batch, (n + 31) / 32), THREADS, 0, s>>>(a, x, L,
                                                                  Lp, n);
  if ((err = (int)cudaGetLastError())) return err;
  for (int b = 0; b < nblk; ++b) {
    if ((err = factor(rpt, x, vd, tm, batch, Lp, n, b, s))) return err;
    const int c_rest = b * NB + NB;
    if (c_rest < n &&
        (err = apply_code(code, true, x, vd, tm, x, Lp, x, Lp, Lp, batch, Lp,
                          n, b, c_rest, n, n, s)))
      return err;
  }
  wide_r_kernel<<<batch, THREADS, 0, s>>>(x, r, Lp, n);
  if ((err = (int)cudaGetLastError())) return err;
  for (int b = nblk - 1; b >= 0; --b) {
    const int c0 = b * NB;
    float* dst = b == 0 ? qt : qw;
    const int ld = b == 0 ? L : Lp;
    if ((err = apply_code(code, false, x, vd, tm, qw, Lp, dst, ld, ld, batch,
                          Lp, n, b, c0, c0, c0 + NB, s)))
      return err;
  }
  return 0;
}

}  // extern "C"
