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
// The algorithm is LAPACK's geqrf + orgqr, blocked by NB columns, in
// compact WY (Y, T):
// * Column j: v = x + sign(x_j) ||x|| e_j over rows >= j, R_jj =
//   -sign(x_j) ||x|| with sign(0) = +1, ||v||^2 = ||x||^2 + 2 sign ||x||
//   x_j + ||x||^2 and beta = 2 / ||v||^2, or 0 where ||v||^2 <= 1e-30
//   (a zero column passes through as H = I).  The rank-1 updates of the
//   block's later columns and the T recurrence T_k = [[T, -beta T Y^T v],
//   [0, beta]] run in float32, one warp per column or dot.
// * Block products at the mode: the trailing update X -= Y (T^T (Y^T X))
//   and, from the right, the Q build Q -= Y (T (Y^T Q)).  Each product
//   splits both operands with splits.cuh (the stream kernel's splits) and
//   keeps the mode's product terms by order; the small T products are
//   float32.
// * Shared memory: the tile lies column-major (column c at At + c * sl,
//   sl = L + 1, so a warp reading one row of many columns hits distinct
//   banks).  The reflectors stay below the diagonal and R above it, as in
//   geqrf; R is written out, and Q is then built in the same buffer block
//   by block from the right, each block's Y copied aside first.  At
//   n = 128, L = 256 that is 128 + 16 KiB for the tile and Y, plus the
//   block products and the T factors (panel_qr_smem_bytes).
// * Zero rows at positions >= n are never a pivot, so every reflector is
//   0 there and their Q rows come out exactly 0 (the tree pads with them).
//
// What bounds it on this card: at (4096, 256, 128) the one read of A and
// the writes of Q^T and R are 1.34 GB (0.40 ms at 3.35 TB/s), and the
// ~4 L n^2 flops a tile are, at bf16x6_cor, six split products of 69 GFLOP
// (0.42 ms on the tensor cores).  This version is far from both: the
// split products run as float32 FMAs on the CUDA cores with every operand
// split where it is used, and the column chain of each tile is serial
// with two barriers a column, one CTA per SM (the tile needs > 113 KB).
// It is the simple, right version; tensor cores (mma.sync / wgmma on the
// split parts), pre-split Y and a shorter chain are later work.

#include <cuda_runtime.h>

#include "splits.cuh"

#define THREADS 256
#define WARPS (THREADS / 32)
#define NB 16          // columns per W-Y block
#define N_MAX 128      // widest n
#define SMEM_MAX 232448  // dynamic shared memory a block may use on sm_90

// Floats of dynamic shared memory for an (L, n) tile:
//   At  n * sl        the tile (then Q), column-major
//   Ys  NB * sl       the current block's reflectors, Ys[k][i]
//   P   NB * n        the block's Y^T X (or Y^T Q)
//   W2  3 * NB * n    the split parts of T^T P (or T P)
//   T   nblk * NB^2   every block's T factor
//   vd  n             each reflector's entry on the diagonal
//   red 2 * WARPS     warp partial sums, Y^T v of the T recurrence
static size_t smem_floats(int L, int n) {
  const size_t sl = L + 1, nblk = (n + NB - 1) / NB;
  return n * sl + NB * sl + 4 * NB * n + nblk * NB * NB + n + 2 * WARPS +
         NB;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// P[k][c] = sum_{i0 <= i < L} Y[k][i] X[c][i] at the mode, for k < nb and
// c_lo <= c < n: one warp per column, its lanes over the rows; each order
// of product terms is summed on its own, then the orders smallest first.
template <int CODE>
__device__ __forceinline__ void block_dots(const float* Ys, const float* At,
                                           int sl, int i0, int L, int c_lo,
                                           int n, int nb, float* P) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int c = c_lo + warp; c < n; c += WARPS) {
    const float* x = At + c * sl;
    float acc[NB][3];
#pragma unroll
    for (int k = 0; k < NB; ++k) acc[k][0] = acc[k][1] = acc[k][2] = 0.f;
    for (int i = i0 + lane; i < L; i += 32) {
      float xp[3];
      split_parts(x[i], CODE, xp);
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        if (k < nb) {
          float yp[3];
          split_parts(Ys[k * sl + i], CODE, yp);
          fma_parts<CODE>(yp, xp, acc[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      if (k < nb) {
        const float s0 = warp_sum(acc[k][0]);
        const float s1 = CODE >= 2 ? warp_sum(acc[k][1]) : 0.f;
        const float s2 = CODE == 3 ? warp_sum(acc[k][2]) : 0.f;
        if (lane == 0) P[k * n + c] = sum_orders(s0, s1, s2, n_parts(CODE) - 1);
      }
    }
  }
}

// X[c][i] -= sum_k Y[k][i] W[k][c] at the mode, for i0 <= i < L and
// c_lo <= c < n, with W given as its split parts (part q of (k, c) at
// W2[(q * NB + k) * n + c]).  One thread per row, its Y parts in
// registers across the columns.
template <int CODE>
__device__ __forceinline__ void block_update(const float* Ys, float* At,
                                             int sl, int i0, int L, int c_lo,
                                             int n, int nb, const float* W2) {
  for (int i = i0 + threadIdx.x; i < L; i += THREADS) {
    float yp[NB][3];
#pragma unroll
    for (int k = 0; k < NB; ++k)
      if (k < nb) split_parts(Ys[k * sl + i], CODE, yp[k]);
    for (int c = c_lo; c < n; ++c) {
      float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        if (k < nb) {
          float wp[3];
          wp[0] = W2[k * n + c];
          if (CODE >= 2) wp[1] = W2[(NB + k) * n + c];
          if (CODE == 3) wp[2] = W2[(2 * NB + k) * n + c];
          fma_parts<CODE>(yp[k], wp, acc);
        }
      }
      float* x = At + c * sl + i;
      *x = __fsub_rn(*x, sum_orders(acc[0], acc[1], acc[2], n_parts(CODE) - 1));
    }
  }
}

// Y[k][i] of block (c0, nb) into Ys for rows i >= c0: 0 above the
// diagonal, vd on it, the stored reflector below it.
__device__ __forceinline__ void copy_y(const float* At, const float* vd,
                                       int sl, int c0, int nb, int L,
                                       float* Ys) {
  const int rows = L - c0;
  for (int e = threadIdx.x; e < nb * rows; e += THREADS) {
    const int k = e / rows, i = c0 + e % rows, j = c0 + k;
    Ys[k * sl + i] = i < j ? 0.f : (i == j ? vd[j] : At[j * sl + i]);
  }
}

template <int CODE>
__global__ void __launch_bounds__(THREADS)
panel_qr_kernel(const float* __restrict__ a, float* __restrict__ qt,
                float* __restrict__ r, int L, int n) {
  extern __shared__ float smem[];
  const int sl = L + 1, nblk = (n + NB - 1) / NB;
  float* At = smem;
  float* Ys = At + n * sl;
  float* P = Ys + NB * sl;
  float* W2 = P + NB * n;
  float* Tall = W2 + 3 * NB * n;
  float* vd = Tall + nblk * NB * NB;
  float* red = vd + n;
  float* ytv = red + 2 * WARPS;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t tile = blockIdx.x;
  const int order = n_parts(CODE) - 1;

  const float* A = a + tile * L * n;
  for (int e = tid; e < L * n; e += THREADS) {
    const int i = e / n, c = e - i * n;
    At[c * sl + i] = A[e];
  }
  __syncthreads();

  // ---- factor: nb reflectors per block, then the trailing update ----
  for (int b = 0; b < nblk; ++b) {
    const int c0 = b * NB, nb = min(NB, n - c0);
    float* T = Tall + b * NB * NB;
    for (int k = 0; k < nb; ++k) {
      const int j = c0 + k;
      float* x = At + j * sl;
      float s = 0.f;
      for (int i = j + tid; i < L; i += THREADS) s = fmaf(x[i], x[i], s);
      s = warp_sum(s);
      if (lane == 0) red[warp] = s;
      __syncthreads();
      float norm2 = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) norm2 = __fadd_rn(norm2, red[w]);
      const float xj = x[j];
      const float sign = xj >= 0.f ? 1.f : -1.f;
      const float norm = sqrtf(norm2);
      const float vnorm2 = __fadd_rn(
          __fadd_rn(norm2, __fmul_rn(__fmul_rn(2.f * sign, norm), xj)), norm2);
      const float beta = vnorm2 > 1e-30f ? __fdiv_rn(2.f, vnorm2) : 0.f;
      const float vj = __fadd_rn(xj, __fmul_rn(sign, norm));
      // one warp per task: the rank-1 update of a later column of the
      // block, or one entry of Y^T v for the T recurrence
      const int ncol = nb - 1 - k;
      for (int task = warp; task < ncol + k; task += WARPS) {
        const bool update = task < ncol;
        float* y = At + (update ? j + 1 + task : c0 + task - ncol) * sl;
        float w = 0.f;
        for (int i = j + 1 + lane; i < L; i += 32) w = fmaf(x[i], y[i], w);
        w = fmaf(vj, y[j], warp_sum(w));
        if (!update) {
          if (lane == 0) ytv[task - ncol] = w;
          continue;
        }
        const float bw = __fmul_rn(beta, w);
        if (lane == 0) y[j] = __fsub_rn(y[j], __fmul_rn(bw, vj));
        for (int i = j + 1 + lane; i < L; i += 32)
          y[i] = __fsub_rn(y[i], __fmul_rn(bw, x[i]));
      }
      __syncthreads();
      if (tid < k) {  // T[:k, k] = -beta T[:k, :k] (Y^T v)
        float t = 0.f;
        for (int p = tid; p < k; ++p) t = fmaf(T[tid * NB + p], ytv[p], t);
        T[tid * NB + k] = -beta * t;
      }
      if (tid == THREADS - 1) {
        T[k * NB + k] = beta;
        vd[j] = vj;
        x[j] = -sign * norm;
      }
    }
    const int c_rest = c0 + nb;
    if (c_rest >= n) break;
    __syncthreads();
    copy_y(At, vd, sl, c0, nb, L, Ys);
    __syncthreads();
    block_dots<CODE>(Ys, At, sl, c0, L, c_rest, n, nb, P);
    __syncthreads();
    for (int e = tid; e < nb * (n - c_rest); e += THREADS) {
      const int k = e / (n - c_rest), c = c_rest + e % (n - c_rest);
      float t = 0.f;  // (T^T P)[k][c]
      for (int q = 0; q <= k; ++q) t = fmaf(T[q * NB + k], P[q * n + c], t);
      float p[3];
      split_parts(t, CODE, p);
      for (int q = 0; q <= order; ++q) W2[(q * NB + k) * n + c] = p[q];
    }
    __syncthreads();
    block_update<CODE>(Ys, At, sl, c0, L, c_rest, n, nb, W2);
    __syncthreads();
  }
  __syncthreads();

  // ---- R: the upper triangle, exact zeros below ----
  float* R = r + tile * n * n;
  for (int e = tid; e < n * n; e += THREADS) {
    const int i = e / n, c = e - i * n;
    R[e] = i <= c ? At[c * sl + i] : 0.f;
  }
  __syncthreads();
  for (int e = tid; e < n * n; e += THREADS) {
    const int c = e / n, i = e - c * n;
    if (i < c) At[c * sl + i] = 0.f;
  }

  // ---- Q = H_0 ... H_{n-1} I_thin, blocks from the right ----
  for (int b = nblk - 1; b >= 0; --b) {
    const int c0 = b * NB, nb = min(NB, n - c0);
    const float* T = Tall + b * NB * NB;
    __syncthreads();
    copy_y(At, vd, sl, c0, nb, L, Ys);
    __syncthreads();
    const int rows = L - c0;
    for (int e = tid; e < nb * rows; e += THREADS) {
      const int k = e / rows, i = c0 + e % rows;
      At[(c0 + k) * sl + i] = i == c0 + k ? 1.f : 0.f;
    }
    __syncthreads();
    block_dots<CODE>(Ys, At, sl, c0, L, c0, n, nb, P);
    __syncthreads();
    for (int e = tid; e < nb * (n - c0); e += THREADS) {
      const int k = e / (n - c0), c = c0 + e % (n - c0);
      float t = 0.f;  // (T P)[k][c]
      for (int q = k; q < nb; ++q) t = fmaf(T[k * NB + q], P[q * n + c], t);
      float p[3];
      split_parts(t, CODE, p);
      for (int q = 0; q <= order; ++q) W2[(q * NB + k) * n + c] = p[q];
    }
    __syncthreads();
    block_update<CODE>(Ys, At, sl, c0, L, c0, n, nb, W2);
  }
  __syncthreads();

  float* Q = qt + tile * n * L;
  for (int e = tid; e < n * L; e += THREADS) {
    const int c = e / L, i = e - c * L;
    Q[e] = At[c * sl + i];
  }
}

template <int CODE>
static int launch(const float* a, float* qt, float* r, int batch, int L,
                  int n, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      panel_qr_kernel<CODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  panel_qr_kernel<CODE><<<batch, THREADS, smem, stream>>>(a, qt, r, L, n);
  return (int)cudaGetLastError();
}

extern "C" {

int panel_qr_n_max(void) { return N_MAX; }
int panel_qr_block(void) { return NB; }
long long panel_qr_smem_bytes(int L, int n) {
  return (long long)smem_floats(L, n) * 4;
}
long long panel_qr_smem_max(void) { return SMEM_MAX; }

// Factor a (batch, L, n) float32 batch into qt (batch, n, L) and r
// (batch, n, n); code is the mode code of splits.cuh.
int panel_qr_launch(const float* a, float* qt, float* r, int batch, int L,
                    int n, int code, void* stream) {
  if (n < 1 || n > N_MAX || L < n || batch < 1 || code < 0 || code > 3)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(L, n) * 4;
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (code) {
    case 0: return launch<0>(a, qt, r, batch, L, n, smem, s);
    case 1: return launch<1>(a, qt, r, batch, L, n, smem, s);
    case 2: return launch<2>(a, qt, r, batch, L, n, smem, s);
    default: return launch<3>(a, qt, r, batch, L, n, smem, s);
  }
}

}  // extern "C"
