// The streaming pass at wide n (128 < n <= 2048): up to three chained
// dots x <- x R_i (or x <- x + x R_i), an optional write of x to Q, and
// an optional compensated half-Gram P of x (the caller forms
// G = P + P^T), each product at its own split mode, as
// stream_gram.cu computes them for n <= 128.
//
// Replaces the wide range of the Pallas kernel
// tsqr_tpu/ops/pallas_gram.py::stream_pallas (64 <= n <= 1024 for
// bf16x6_cor and bf16x3_cor, <= 2048 for the single-part modes,
// tsqr_tpu/core/cholqr.py::_fused_n_max); the float64 partials are summed
// by stream_gram.cu's stream_gram_reduce_kernel.  No tile here grows
// with n, so every mode runs to 2048: the fp32 pipelines' bf16x3_cor
// corrections need it past 1024.
//
// What bounds it on the H100.  The split products: a bf16x6_cor dot does
// 6 products of 2 m n^2 flops for 8 bytes of A and Q a row element, past
// the card's ~295 bf16 operations a byte once n >~ 200; at (2^19, 512) the
// tier-1 Gram + Q pass is 2.7 TFLOP of bf16 products (2.8 ms at
// 989 TFLOP/s) against 3.2 GB (0.96 ms at 3.35 TB/s).
//
// Why the design differs from the n <= 128 kernel.  The TPU kernel keeps
// (2 + parts n_r) n^2 floats in 100 MB of VMEM; at n = 1024 one (n, n)
// float32 matrix is 4 MiB, 18x the 227 KB a CTA can use, and a block of
// rows of x across all n columns holds too few rows for R's traffic from
// L2 not to dominate.  So each stage is a tiled kernel of its own:
// * wide_split_x_kernel: x (float32, or bf16 A) is split once into its
//   bf16 parts in device memory (a chunk's rows, k padded to KS), the
//   operand of the next dot or of the Gram: the products' loops only copy
//   and multiply, and no x element is split again per output tile.
// * wide_dot_kernel: one dot as a tiled product, 128 x 128 of the output
//   a CTA, over k-slices of 32: x's parts and R's parts come through a
//   3-slot cp.async ring (one barrier a slice); the split products run
//   on mma.sync m16n8k16, a warp 32 x 64 of the output in two float32
//   fragments, order 0 and the orders above it together (their terms are
//   2^-8 and 2^-16 of x's: one fragment holds them at the mode's grade,
//   and frees the registers for the wider tile, which halves x's reads
//   from L2 against 128 x 64 tiles: 8.09 -> 6.75 ms at (2^19, 512),
//   PERF.md).  Order 0 joins its sum by a rounded add a k-step: the
//   tensor core's own float32 accumulation drifted 1.2e-6 from the plain
//   version over n = 1024.  R is split once a launch by
//   wide_split_r_kernel into a padded image read from L2.  The fp32 mode,
//   which must not round its operands, runs float32 FMAs on the CUDA
//   cores from x itself (wide_dot_fp32_kernel, 128 x 128 tiles).
// * wide_gram_kernel: the half-Gram, one 128 x 128 block of P a CTA over
//   one slab of SLAB rows; the slab's parts come through a 4-slot ring
//   and are multiplied as stream_gram.cu's gram_mma does, in two
//   fragments as the dot's (x0^T x0, and x0^T x1 + x0^T x2 +
//   x1^T (x1 / 2), the half exact in the fragment); order 0 added
//   k-step by k-step with a rounded add; once a slab folded into the
//   float64 partial of the slab's place in its chunk.  P is formed
//   whole, every block, as the TPU kernel forms it.  fp32: float32 FMAs
//   from x, 8 x 8 entries a thread (wide_gram_fp32_kernel).
// * Calls with dots and a Gram run the dots, then the Gram over what they
//   wrote: Q where Q is float32 x, else a float32 scratch buffer.  So the
//   pass moves more bytes than the TPU kernel's single pass: a product
//   after the first reads its x again, and each product writes and reads
//   x's parts (harness/flops.py::wide_extra_bytes counts them; PERF.md
//   gives that design bound beside the function's).
// * Rows go in chunks of chunk_rows(n) (slabs_per_chunk(n) slabs of SLAB
//   rows, enough for whole waves of Gram CTAs: at n = 1024 six, 384
//   CTAs, where five left the third wave 42 % full): each chunk's dots,
//   Gram and Q write are launched in turn, so the scratch buffers hold
//   one chunk (a bounded extra memory), and Q may
//   be written over A (alias_q): a chunk's last dot reads scratch, not A,
//   or, for a single dot, writes scratch and wide_store_kernel copies it
//   over A once the dot has read it.
// * Deterministic: every element of x comes from the same dot code
//   whatever the call kind (the same mma and fmaf sequence, explicit
//   __fadd_rn), and the Gram's slabs, chunks and partials depend on m and n
//   alone; slab g of every chunk adds into partial g in chunk order, and
//   the reduction sums the partials in a fixed order.  A Gram-only and a
//   Q-writing call with the same dots give the same bits.
// * wgmma and TMA are not used: this is the first, mma.sync step; its
//   times are in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "splits.cuh"  // n_parts, split_parts, sum_orders

#define THREADS 256
#define WIDE_N_MAX 2048
#define SLAB 1024        // rows a Gram CTA sums in float32 before a fold
#define SMS 132          // the H100's SMs: a chunk's Gram fills whole waves
// the dot on the tensor cores
#define DM 128           // output rows of a CTA
#define DN 128           // output columns of a CTA
#define KS 32            // k-slice of a ring slot
#define PSTAGES 3        // the ring of x's and R's parts
#define PSTR (KS + 8)    // bf16 row stride of an x part slice
#define RSTR (DN + 8)    // bf16 row stride of an R part slice
// the fp32 dot
#define DSTAGES 3
#define XSTR (KS + 4)    // float32 row stride of an x slot (words)
#define FM 128
#define FN 128
#define FRSTR (FN + 4)
// the Gram on the tensor cores: 128 x 128 blocks of P
#define GM 128           // rows and columns of a P block
#define TR 32            // x rows of a ring slot
#define GSTAGES 4
#define GP (GM + 8)      // bf16 row stride of a panel's part
// the fp32 Gram: the same blocks, float32 x rows in the ring
#define FTR 64
#define FGSTAGES 3
#define GASTR (GM + 4)
// the R image: k padded to KS, columns to 128 (both dot tilings)
#define KPAD(n) (((n) + KS - 1) / KS * KS)
#define NPAD(n) (((n) + 127) / 128 * 128)

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
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

// c += A B: A 16x16 bf16 (row), B 16x8 bf16 (col), c 16x8 float32; lane
// 4 g + t holds c = {(g, 2t..2t+1), (g+8, 2t..2t+1)}.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragments of two neighbouring n8 tiles (k0 .. k0+15, n0 .. n0+15)
// of a [k][n] bf16 array of row stride `stride`.
__device__ __forceinline__ void load_b2(uint32_t b[2][2], const bf16* base,
                                        int stride, int k0, int n0,
                                        int lane) {
  uint32_t t[4];
  ldsm_x4_t(t, base + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * stride +
                   n0 + (lane >> 4) * 8);
  b[0][0] = t[0];
  b[0][1] = t[1];
  b[1][0] = t[2];
  b[1][1] = t[3];
}

__device__ __forceinline__ float load_x(const void* src, int src_bf16,
                                        long long i) {
  return src_bf16 ? __bfloat162float(static_cast<const bf16*>(src)[i])
                  : static_cast<const float*>(src)[i];
}

// Start the copy of a rows x cols float32 block (cols a multiple of 4)
// of x, rows from row0 and columns from col0, into a shared slot of row
// stride `stride`; zero past `rows` and n.  A float32 x goes by cp.async
// (16 bytes where n is a multiple of 4 and x 16-byte aligned, else 4); a
// bf16 x is loaded and widened at once (the slot is free when it is
// issued).
template <int ROWS, int COLS>
__device__ __forceinline__ void issue_x(const void* src, int src_bf16,
                                        int fast, long long rows, int n,
                                        long long row0, int col0, float* slot,
                                        int stride) {
  constexpr int PER = COLS / 4;
  for (int i = threadIdx.x; i < ROWS * PER; i += THREADS) {
    const int r = i / PER, c = (i % PER) * 4;
    const long long g = row0 + r;
    const int k = col0 + c;
    float* dst = slot + r * stride + c;
    if (!src_bf16 && fast) {
      const bool in = g < rows && k < n;
      const float* s = static_cast<const float*>(src);
      cp_async16(dst, in ? s + g * n + k : s, in ? 16 : 0);
    } else if (!src_bf16) {
      const float* s = static_cast<const float*>(src);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool in = g < rows && k + e < n;
        cp_async4(dst + e, in ? s + g * n + k + e : s, in ? 4 : 0);
      }
    } else {
      const bf16* s = static_cast<const bf16*>(src);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = (g < rows && k + e < n) ? __bfloat162float(s[g * n + k + e])
                                       : 0.f;
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

// The bf16 parts of four float32 values (split_parts' arithmetic, two
// values a conversion): w[q] = part q of (v.x, v.y), (v.z, v.w).
template <int P>
__device__ __forceinline__ void split4(float4 v, __nv_bfloat162 w[3][2]) {
  const float2 x2[2] = {make_float2(v.x, v.y), make_float2(v.z, v.w)};
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    w[0][e] = __float22bfloat162_rn(x2[e]);
    if (P >= 2) {
      const float2 f0 = __bfloat1622float2(w[0][e]);
      const float2 r0 = make_float2(__fsub_rn(x2[e].x, f0.x),
                                    __fsub_rn(x2[e].y, f0.y));
      w[1][e] = __float22bfloat162_rn(r0);
      if (P == 3) {
        const float2 f1 = __bfloat1622float2(w[1][e]);
        w[2][e] = __float22bfloat162_rn(
            make_float2(__fsub_rn(r0.x, f1.x), __fsub_rn(r0.y, f1.y)));
      }
    }
  }
}

// Write a value of the dot's output: y, or x + y for a residual dot.
__device__ __forceinline__ void put_y(const void* src, int src_bf16,
                                      void* dst, int dst_bf16, int residual,
                                      long long i, float y) {
  if (residual) y = __fadd_rn(load_x(src, src_bf16, i), y);
  if (dst_bf16)
    static_cast<bf16*>(dst)[i] = __float2bfloat16_rn(y);
  else
    static_cast<float*>(dst)[i] = y;
}

// ---------------------------------------------------------------------
// R: the prologue split, once per launch, into the padded image:
// parts [q][kpad][npad] bf16 (codes 1-3) or [kpad][npad] float32 (0).

struct SplitParams {
  const float* r[3];
  unsigned char* image;
  long long image_bytes;  // a dot's image
  int code[3], n_dots, n, kpad, npad;
};

__global__ void wide_split_r_kernel(SplitParams sp) {
  const long long per = (long long)sp.kpad * sp.npad;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= sp.n_dots * per) return;
  const int d = (int)(idx / per);
  const long long e = idx % per;
  const int k = (int)(e / sp.npad), c = (int)(e % sp.npad);
  const float* r = d == 0 ? sp.r[0] : (d == 1 ? sp.r[1] : sp.r[2]);
  const int code = d == 0 ? sp.code[0] : (d == 1 ? sp.code[1] : sp.code[2]);
  const float v = (k < sp.n && c < sp.n) ? r[(long long)k * sp.n + c] : 0.f;
  unsigned char* img = sp.image + d * sp.image_bytes;
  if (code == 0) {
    reinterpret_cast<float*>(img)[e] = v;
    return;
  }
  float p[3];
  split_parts(v, code, p);
  bf16* parts = reinterpret_cast<bf16*>(img);
  for (int q = 0; q < n_parts(code); ++q)
    parts[q * per + e] = __float2bfloat16_rn(p[q]);
}

// ---------------------------------------------------------------------
// x: the split into bf16 parts, part q at parts + q * plane, row r at
// r * kp (k padded with zeros to kp), a chunk's rows at a time.

struct SplitXParams {
  const void* src;
  bf16* parts;
  long long rows, plane;
  int n, kp, src_bf16, src_fast, code;
};

__global__ void wide_split_x_kernel(SplitXParams p) {
  const int np = p.code <= 1 ? 1 : p.code;
  for (long long r = blockIdx.x; r < p.rows; r += gridDim.x)
    for (int c = 4 * threadIdx.x; c < p.kp; c += 4 * blockDim.x) {
      float4 f;
      if (p.src_fast && c < p.n) {  // four float32 a 16-byte load
        f = *reinterpret_cast<const float4*>(
            static_cast<const float*>(p.src) + r * p.n + c);
      } else {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = c + e < p.n ? load_x(p.src, p.src_bf16, r * p.n + c + e)
                             : 0.f;
        f = make_float4(v[0], v[1], v[2], v[3]);
      }
      __nv_bfloat162 w[3][2];
      if (p.code == 3)
        split4<3>(f, w);
      else if (p.code == 2)
        split4<2>(f, w);
      else
        split4<1>(f, w);
      for (int q = 0; q < np; ++q)
        *reinterpret_cast<uint2*>(p.parts + q * p.plane + r * p.kp + c) =
            make_uint2(bits(w[q][0]), bits(w[q][1]));
    }
}

// ---------------------------------------------------------------------
// The dot.

struct DotParams {
  const void* src;         // x: the residual's addend; fp32's operand
  const bf16* parts;       // x's parts (codes 1-3)
  void* dst;
  const unsigned char* image;
  long long rows, plane;
  int n, kpad, npad, src_bf16, src_fast, dst_bf16, residual;
};

__host__ __device__ inline int dot_smem(int code) {
  if (code == 0) return DSTAGES * (FM * XSTR + KS * FRSTR) * 4;
  const int p = code <= 1 ? 1 : code;
  return PSTAGES * p * (DM * PSTR + KS * RSTR) * 2;
}

// The tile (DM rows from blockIdx.y, DN columns from blockIdx.x) at a bf16
// split mode: each warp computes 32 rows x 64 columns in two float32
// fragments, order 0 and the orders above it (their products are 2^-8
// and 2^-16 of x's and sum in one fragment without loss of the mode's
// grade); k in order, then the terms, highest order first.
template <int CODE>
__global__ void __launch_bounds__(THREADS, 1) wide_dot_kernel(DotParams p) {
  constexpr int P = CODE <= 1 ? 1 : CODE, ORDER = P - 1;
  constexpr int XSLOT = P * DM * PSTR, RSLOT = P * KS * RSTR;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* rs = xs + PSTAGES * XSLOT;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = 32 * (warp & 3), wc = 64 * (warp >> 2);
  const int c0 = blockIdx.x * DN;
  const long long row0 = (long long)blockIdx.y * DM;
  const int KT = p.kpad / KS;
  const long long per = (long long)p.kpad * p.npad;
  const bf16* rimg = reinterpret_cast<const bf16*>(p.image);

  auto issue = [&](int kt, int s) {
    // x's parts: DM x KS bf16 a part, four 16-byte copies a row
#pragma unroll
    for (int it = 0; it < DM * KS / 8 / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i >> 2, c8 = (i & 3) * 8;
      const long long gr = row0 + r;
      const bool in = gr < p.rows;
#pragma unroll
      for (int q = 0; q < P; ++q)
        cp_async16(xs + s * XSLOT + q * DM * PSTR + r * PSTR + c8,
                   in ? p.parts + q * p.plane + gr * p.kpad + kt * KS + c8
                      : p.parts,
                   in ? 16 : 0);
    }
    // R's parts: KS x DN bf16 a part, sixteen 16-byte copies a row
#pragma unroll
    for (int it = 0; it < KS * DN / 8 / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i >> 4, c8 = (i & 15) * 8;
#pragma unroll
      for (int q = 0; q < P; ++q)
        cp_async16(rs + s * RSLOT + q * KS * RSTR + r * RSTR + c8,
                   rimg + q * per + (long long)(kt * KS + r) * p.npad + c0 +
                       c8,
                   16);
    }
  };

  float acc0[2][8][4], acc1[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc0[i][j][e] = acc1[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < PSTAGES - 1; ++s) {
    if (s < KT) issue(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<PSTAGES - 2>();
    __syncthreads();  // slice kt is in its slot; slot kt - 1 is free
    if (kt + PSTAGES - 1 < KT)
      issue(kt + PSTAGES - 1, (kt + PSTAGES - 1) % PSTAGES);
    cp_commit();
    const bf16* XP = xs + (kt % PSTAGES) * XSLOT;
    const bf16* R = rs + (kt % PSTAGES) * RSLOT;
#pragma unroll
    for (int k0 = 0; k0 < KS; k0 += 16) {
      uint32_t af[3][2][4];
#pragma unroll
      for (int q = 0; q < P; ++q)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4(af[q][i], XP + q * DM * PSTR +
                                (wr + 16 * i + (lane & 15)) * PSTR + k0 +
                                (lane >> 4) * 8);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {  // two n8 tiles of R at a time
        uint32_t bf[3][2][2];
#pragma unroll
        for (int q = 0; q < P; ++q)
          load_b2(bf[q], R + q * KS * RSTR, RSTR, k0, wc + 16 * jj, lane);
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
                  mma_bf16(acc1[i][j], af[u][i], bf[v][jl][0], bf[v][jl][1]);
              }
            // order 0 carries x's magnitude: each k-step's product starts
            // from zero and joins the sum by a rounded add, so the tensor
            // core's accumulation rounding is not repeated over n
            float t0[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(t0, af[0][i], bf[0][jl][0], bf[0][jl][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc0[i][j][e] = __fadd_rn(acc0[i][j][e], t0[e]);
          }
      }
    }
  }
  cp_wait<0>();
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const long long row = row0 + wr + 16 * i + g + (e >= 2 ? 8 : 0);
        const int col = c0 + wc + 8 * j + 2 * t + (e & 1);
        if (row < p.rows && col < p.n)
          put_y(p.src, p.src_bf16, p.dst, p.dst_bf16, p.residual,
                row * p.n + col,
                ORDER ? __fadd_rn(acc1[i][j][e], acc0[i][j][e])
                      : acc0[i][j][e]);
      }
}

// The same at fp32 mode (one unrounded part) by float32 FMAs, k in
// order: a CTA computes FM rows x FN columns, each thread 8 x 8, its
// rows 16 apart (the two half-warps' x reads then fall in other banks).
__global__ void __launch_bounds__(THREADS, 1)
    wide_dot_fp32_kernel(DotParams p) {
  constexpr int XSLOT = FM * XSTR, RSLOT = KS * FRSTR;
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);
  float* rs = xs + DSTAGES * XSLOT;
  const int tid = threadIdx.x;
  const int r0 = tid >> 4, cc = 8 * (tid & 15);
  const int c0 = blockIdx.x * FN;
  const long long row0 = (long long)blockIdx.y * FM;
  const int KT = p.kpad / KS;
  const float* rimg = reinterpret_cast<const float*>(p.image);

  auto issue = [&](int kt, int s) {
    issue_x<FM, KS>(p.src, p.src_bf16, p.src_fast, p.rows, p.n, row0,
                    kt * KS, xs + s * XSLOT, XSTR);
#pragma unroll
    for (int it = 0; it < KS * FN / 4 / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i >> 5, c4 = (i & 31) * 4;
      cp_async16(rs + s * RSLOT + r * FRSTR + c4,
                 rimg + (long long)(kt * KS + r) * p.npad + c0 + c4, 16);
    }
  };

  float b[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) b[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < DSTAGES - 1; ++s) {
    if (s < KT) issue(s, s);
    cp_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_wait<DSTAGES - 2>();
    __syncthreads();  // slice kt is in its slot; slot kt - 1 is free
    if (kt + DSTAGES - 1 < KT)
      issue(kt + DSTAGES - 1, (kt + DSTAGES - 1) % DSTAGES);
    cp_commit();
    const float* X = xs + (kt % DSTAGES) * XSLOT;
    const float* R = rs + (kt % DSTAGES) * RSLOT;
#pragma unroll 2
    for (int k = 0; k < KS; ++k) {
      const float4 ra = *reinterpret_cast<const float4*>(R + k * FRSTR + cc);
      const float4 rc =
          *reinterpret_cast<const float4*>(R + k * FRSTR + cc + 4);
      const float rv[8] = {ra.x, ra.y, ra.z, ra.w, rc.x, rc.y, rc.z, rc.w};
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xv = X[(r0 + 16 * i) * XSTR + k];
#pragma unroll
        for (int j = 0; j < 8; ++j) b[i][j] = fmaf(xv, rv[j], b[i][j]);
      }
    }
  }
  cp_wait<0>();
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long row = row0 + r0 + 16 * i;
      const int col = c0 + cc + j;
      if (row < p.rows && col < p.n)
        put_y(p.src, p.src_bf16, p.dst, p.dst_bf16, p.residual,
              row * p.n + col, b[i][j]);
    }
}

// ---------------------------------------------------------------------
// The half-Gram: block (bi, bj) of P = rows [128 bi, +128), columns
// [64 bj, +64), over slab blockIdx.y of the chunk, into partial
// blockIdx.y.

struct GramParams {
  const void* src;         // x (fp32)
  const bf16* parts;       // x's parts (codes 1-3)
  double* partials;
  long long rows, plane;
  int n, nbj, kpad, src_bf16, src_fast, first;
};

__host__ __device__ inline int gram_smem(int code) {
  if (code == 0) return FGSTAGES * FTR * 2 * GASTR * 4;
  const int na = code == 3 ? 2 : 1, nb = code <= 1 ? 1 : code;
  return GSTAGES * TR * GP * (na + nb) * 2;
}

// Add a folded slab entry into the float64 partial (or write it, for the
// first chunk); `old` was read before, so that the reads are in flight
// together.
__device__ __forceinline__ double read_entry(const double* part, int n,
                                             int row, int col, bool first) {
  return (row < n && col < n && !first) ? part[(size_t)row * n + col] : 0.0;
}

__device__ __forceinline__ void write_entry(double* part, int n, int row,
                                            int col, double old, float c) {
  if (row < n && col < n) part[(size_t)row * n + col] = old + (double)c;
}

// Half of both bf16 of a fragment register, exactly.
__device__ __forceinline__ uint32_t halved(uint32_t u) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&u);
  v = __hmul2(v, __float2bfloat162_rn(0.5f));
  return bits(v);
}

// Copy TR rows x GM columns of each of the first NP parts, rows from row0
// (zero past r_hi) and columns from col0 (zero past kpad), into a slot.
template <int NP>
__device__ __forceinline__ void issue_parts(const GramParams& p,
                                            long long row0, long long r_hi,
                                            int col0, bf16* slot) {
  constexpr int PER = GM / 8;
#pragma unroll
  for (int it = 0; it < TR * PER / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / PER, c8 = (i % PER) * 8;
    const long long g = row0 + r;
    const bool in = g < r_hi && col0 + c8 < p.kpad;
#pragma unroll
    for (int q = 0; q < NP; ++q)
      cp_async16(slot + q * TR * GP + r * GP + c8,
                 in ? p.parts + q * p.plane + g * p.kpad + col0 + c8
                    : p.parts,
                 in ? 16 : 0);
  }
}

// The block at a bf16 split mode, from x's parts: warp w owns P rows
// 32 (w % 4) .. +31 and columns 64 (w / 4) .. +63 of the block, in two
// float32 fragments: [0] x0^T x0 (halved at the fold) and [1] the terms
// above it, x0^T x1 (+ x0^T x2 + x1^T (x1 / 2) at bf16x6_cor; the halves
// are exact).
template <int GCODE>
__global__ void __launch_bounds__(THREADS, 1) wide_gram_kernel(GramParams p) {
  constexpr int NA = GCODE == 3 ? 2 : 1, NB = GCODE <= 1 ? 1 : GCODE;
  constexpr int ASLOT = NA * TR * GP, BSLOT = NB * TR * GP;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* pa = reinterpret_cast<bf16*>(smem);
  bf16* pb = pa + GSTAGES * ASLOT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ca = GM * (blockIdx.x / p.nbj), cb = GM * (blockIdx.x % p.nbj);
  const long long r_lo = (long long)blockIdx.y * SLAB;
  const long long r_hi = r_lo + SLAB < p.rows ? r_lo + SLAB : p.rows;
  const int tiles = (int)((r_hi - r_lo + TR - 1) / TR);
  const int a0 = 32 * (warp & 3), b0 = 64 * (warp >> 2);

  auto issue = [&](int tl, int s) {
    issue_parts<NA>(p, r_lo + tl * TR, r_hi, ca, pa + s * ASLOT);
    issue_parts<NB>(p, r_lo + tl * TR, r_hi, cb, pb + s * BSLOT);
  };

  float acc0[2][8][4], acc1[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc0[i][j][e] = acc1[i][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < GSTAGES - 1; ++s) {
    if (s < tiles) issue(s, s);
    cp_commit();
  }
  for (int tl = 0; tl < tiles; ++tl) {
    cp_wait<GSTAGES - 2>();
    __syncthreads();  // tile tl is in its slot; slot tl - 1 is free
    if (tl + GSTAGES - 1 < tiles)
      issue(tl + GSTAGES - 1, (tl + GSTAGES - 1) % GSTAGES);
    cp_commit();
    const bf16* PA = pa + (tl % GSTAGES) * ASLOT;
    const bf16* PB = pb + (tl % GSTAGES) * BSLOT;
#pragma unroll
    for (int k0 = 0; k0 < TR; k0 += 16) {
      uint32_t af[2][2][4];
#pragma unroll
      for (int q = 0; q < NA; ++q)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldsm_x4_t(af[q][i], PA + q * TR * GP +
                                  (k0 + (lane & 7) + (lane >> 4) * 8) * GP +
                                  a0 + 16 * i + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {  // two n8 tiles of B at a time
        uint32_t bf[3][2][2], h1[2][2];
#pragma unroll
        for (int q = 0; q < NB; ++q)
          load_b2(bf[q], PB + q * TR * GP, GP, k0, b0 + 16 * jj, lane);
        if (NB == 3)
#pragma unroll
          for (int jl = 0; jl < 2; ++jl) {
            h1[jl][0] = halved(bf[1][jl][0]);
            h1[jl][1] = halved(bf[1][jl][1]);
          }
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int jl = 0; jl < 2; ++jl) {
            const int j = 2 * jj + jl;
            if (GCODE == 3) {
              mma_bf16(acc1[i][j], af[0][i], bf[2][jl][0], bf[2][jl][1]);
              mma_bf16(acc1[i][j], af[1][i], h1[jl][0], h1[jl][1]);
            }
            if (GCODE >= 2)
              mma_bf16(acc1[i][j], af[0][i], bf[1][jl][0], bf[1][jl][1]);
            // order 0 carries G's magnitude: each k-step's products
            // start from zero and join the slab's sum by a rounded add
            float t0[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(t0, af[0][i], bf[0][jl][0], bf[0][jl][1]);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              acc0[i][j][e] = __fadd_rn(acc0[i][j][e], t0[e]);
          }
      }
    }
  }
  cp_wait<0>();

  // the fold: the higher orders, then order 0, into the slab's partial
  double* part = p.partials + (size_t)blockIdx.y * p.n * p.n;
  const bool first = p.first != 0;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int jh = 0; jh < 8; jh += 4) {
      double old[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          old[j][e] = read_entry(
              part, p.n, ca + a0 + 16 * i + g + (e >= 2 ? 8 : 0),
              cb + b0 + 8 * (jh + j) + 2 * t + (e & 1), first);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float h0 = __fmul_rn(0.5f, acc0[i][jh + j][e]);
          const float c =
              GCODE >= 2 ? __fadd_rn(acc1[i][jh + j][e], h0) : h0;
          write_entry(part, p.n, ca + a0 + 16 * i + g + (e >= 2 ? 8 : 0),
                      cb + b0 + 8 * (jh + j) + 2 * t + (e & 1), old[j][e],
                      c);
        }
    }
}

// The block at fp32 mode (one unrounded part) by float32 FMAs over the
// slab's rows in order, a tile's rows summed on their own, from x
// itself: thread owns P rows 8 (tid / 16) .. +7 and columns 8 (tid % 16)
// .. +7 of the block.
__global__ void __launch_bounds__(THREADS, 1)
    wide_gram_fp32_kernel(GramParams p) {
  constexpr int SLOT = FTR * GASTR;
  extern __shared__ __align__(16) unsigned char smem[];
  float* as = reinterpret_cast<float*>(smem);
  float* bs = as + FGSTAGES * SLOT;
  const int tid = threadIdx.x;
  const int ca = GM * (blockIdx.x / p.nbj), cb = GM * (blockIdx.x % p.nbj);
  const long long r_lo = (long long)blockIdx.y * SLAB;
  const long long r_hi = r_lo + SLAB < p.rows ? r_lo + SLAB : p.rows;
  const int tiles = (int)((r_hi - r_lo + FTR - 1) / FTR);
  const int a0 = 8 * (tid >> 4), b0 = 8 * (tid & 15);

  auto issue = [&](int tl, int s) {
    issue_x<FTR, GM>(p.src, p.src_bf16, p.src_fast, r_hi, p.n,
                     r_lo + tl * FTR, ca, as + s * SLOT, GASTR);
    issue_x<FTR, GM>(p.src, p.src_bf16, p.src_fast, r_hi, p.n,
                     r_lo + tl * FTR, cb, bs + s * SLOT, GASTR);
  };

  float s32[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s32[i][j] = 0.f;
#pragma unroll
  for (int s = 0; s < FGSTAGES - 1; ++s) {
    if (s < tiles) issue(s, s);
    cp_commit();
  }
  for (int tl = 0; tl < tiles; ++tl) {
    cp_wait<FGSTAGES - 2>();
    __syncthreads();  // tile tl is in its slot; slot tl - 1 is free
    if (tl + FGSTAGES - 1 < tiles)
      issue(tl + FGSTAGES - 1, (tl + FGSTAGES - 1) % FGSTAGES);
    cp_commit();
    const float* XA = as + (tl % FGSTAGES) * SLOT;
    const float* XB = bs + (tl % FGSTAGES) * SLOT;
    // the tile's sums start from zero and join the slab's by a rounded
    // add, so that rounding does not grow over the slab's 1024 rows (a
    // bf16 A put a single running sum 2.6e-6 off the plain version)
    float t32[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) t32[i][j] = 0.f;
#pragma unroll 2
    for (int k = 0; k < FTR; ++k) {
      const float4 xa = *reinterpret_cast<const float4*>(XA + k * GASTR + a0);
      const float4 xe =
          *reinterpret_cast<const float4*>(XA + k * GASTR + a0 + 4);
      const float4 xb = *reinterpret_cast<const float4*>(XB + k * GASTR + b0);
      const float4 xc =
          *reinterpret_cast<const float4*>(XB + k * GASTR + b0 + 4);
      const float va[8] = {xa.x, xa.y, xa.z, xa.w, xe.x, xe.y, xe.z, xe.w};
      const float vb[8] = {xb.x, xb.y, xb.z, xb.w, xc.x, xc.y, xc.z, xc.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) t32[i][j] = fmaf(va[i], vb[j], t32[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s32[i][j] = __fadd_rn(s32[i][j], t32[i][j]);
  }
  cp_wait<0>();
  double* part = p.partials + (size_t)blockIdx.y * p.n * p.n;
  const bool first = p.first != 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    double old[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      old[j] = read_entry(part, p.n, ca + a0 + i, cb + b0 + j, first);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      write_entry(part, p.n, ca + a0 + i, cb + b0 + j, old[j],
                  __fmul_rn(0.5f, s32[i][j]));
  }
}

// ---------------------------------------------------------------------
// Q from a float32 x (scratch) or from A itself: a converting copy.

__global__ void wide_store_kernel(const void* src, int src_bf16, void* dst,
                                  int dst_bf16, long long count) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x) {
    const float v = load_x(src, src_bf16, i);
    if (dst_bf16)
      static_cast<bf16*>(dst)[i] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(dst)[i] = v;
  }
}

// ---------------------------------------------------------------------
// Host side.

typedef void (*DotFn)(DotParams);
typedef void (*GramFn)(GramParams);

static DotFn dot_for(int code) {
  switch (code) {
    case 0: return wide_dot_fp32_kernel;
    case 1: return wide_dot_kernel<1>;
    case 2: return wide_dot_kernel<2>;
    default: return wide_dot_kernel<3>;
  }
}

static GramFn gram_for(int code) {
  switch (code) {
    case 0: return wide_gram_fp32_kernel;
    case 1: return wide_gram_kernel<1>;
    case 2: return wide_gram_kernel<2>;
    default: return wide_gram_kernel<3>;
  }
}

// P's blocks of GM x GM: their number along a side, and in all.
static int gram_nbj(int n) { return (n + GM - 1) / GM; }

static int gram_blocks(int n) { return gram_nbj(n) * gram_nbj(n); }

// Slabs a chunk: at least two waves of Gram CTAs (one a block and slab),
// the fewest whose last wave is >= 95 % full (else the fullest up to
// twice that many).  The dots' CTAs follow the chunk's rows.
static int slabs_per_chunk(int n) {
  const int b = gram_blocks(n);
  const int g0 = (2 * SMS + b - 1) / b;
  int best = g0;
  double best_fill = 0.0;
  for (int g = g0; g <= 2 * g0; ++g) {
    const int ctas = b * g, waves = (ctas + SMS - 1) / SMS;
    const double fill = (double)ctas / (waves * SMS);
    if (fill >= 0.95) return g;
    if (fill > best_fill) {
      best_fill = fill;
      best = g;
    }
  }
  return best;
}

static long long image_bytes(int n) {
  // three bf16 parts or one float32 image, whichever is larger
  return (long long)KPAD(n) * NPAD(n) * 6;
}

static bool src_fast(const void* src, int src_bf16, int n) {
  return !src_bf16 && n % 4 == 0 && (uintptr_t)src % 16 == 0;
}

// Split `rows` rows of x into `parts` at `code` (1-3).
static cudaError_t split_x(const void* src, int src_bf16, long long rows,
                           int n, int code, bf16* parts, long long plane,
                           cudaStream_t st) {
  SplitXParams p;
  p.src = src;
  p.parts = parts;
  p.rows = rows;
  p.plane = plane;
  p.n = n;
  p.kp = KPAD(n);
  p.src_bf16 = src_bf16;
  p.src_fast = src_fast(src, src_bf16, n);
  p.code = code;
  // a CTA a row at a time, a thread four columns
  const long long blocks = rows < 16384 ? rows : 16384;
  wide_split_x_kernel<<<(unsigned)blocks, 128, 0, st>>>(p);
  return cudaGetLastError();
}

extern "C" {

int stream_wide_n_max(void) { return WIDE_N_MAX; }
int stream_wide_slab_rows(void) { return SLAB; }
int stream_wide_kpad(int n) { return KPAD(n); }
long long stream_wide_chunk_rows(int n) {
  return (long long)slabs_per_chunk(n) * SLAB;
}
long long stream_wide_image_bytes(int n) { return image_bytes(n); }

// A Gram call's float64 partials: one (n, n) slab a place in a chunk,
// min(slabs_per_chunk, ceil(m / SLAB)) of them.
int stream_wide_slabs(long long m, int n) {
  const long long used = (m + SLAB - 1) / SLAB;
  const int g = slabs_per_chunk(n);
  return (int)(used < g ? used : g);
}

// Whether a call needs the two float32 scratch buffers of a chunk each:
// for the dots before the last, and for the last where it cannot write Q
// (Q written over A by a single dot, or a Gram of a float32 x beside a
// bf16 Q).
int stream_wide_needs_scratch(int n_dots, int write_q, int alias_q,
                              int gram_code, int q_bf16) {
  const int last_to_q = write_q && !(alias_q && n_dots == 1) &&
                        (gram_code < 0 || !q_bf16);
  return n_dots >= 2 || (n_dots == 1 && !last_to_q);
}

// The whole pass, chunk by chunk of stream_wide_chunk_rows(n) rows, on
// `stream`: for each chunk its dots (each on x's parts, split first,
// into scratch or Q), the Gram of the result into `partials`, and Q's
// write where the last dot could not write it.  `parts` holds three
// planes of min(m, chunk rows) x stream_wide_kpad(n) bf16.  Counts each
// kernel's launches into launches[0..6]: split-mode dots, split-mode
// Grams, stores, R splits, x splits, fp32 dots, fp32 Grams.
int stream_wide_launch(const void* a, int a_bf16, const float* r0,
                       const float* r1, const float* r2, int n_dots,
                       int code0, int code1, int code2, int res0, int res1,
                       int res2, void* image, void* q, int q_bf16,
                       int write_q, int alias_q, int gram_code,
                       double* partials, float* scratch0, float* scratch1,
                       void* parts, long long m, int n, void* stream,
                       int* launches) {
  const int codes[3] = {code0, code1, code2};
  const int res[3] = {res0, res1, res2};
  bool need_parts = gram_code > 0;
  for (int d = 0; d < n_dots; ++d) {
    if (codes[d] < 0 || codes[d] > 3) return (int)cudaErrorInvalidValue;
    need_parts = need_parts || codes[d] > 0;
  }
  const int scratch = stream_wide_needs_scratch(n_dots, write_q, alias_q,
                                                gram_code, q_bf16);
  if (n < 1 || n > WIDE_N_MAX || m < 1 || n_dots < 0 || n_dots > 3 ||
      gram_code > 3 || (!write_q && gram_code < 0) || (n_dots && !image) ||
      (gram_code >= 0 && !partials) || (write_q && !q) ||
      (scratch && (!scratch0 || !scratch1)) || (need_parts && !parts))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int kpad = KPAD(n), npad = NPAD(n);
  const long long mc = stream_wide_chunk_rows(n);
  const long long plane = (mc < m ? mc : m) * kpad;
  bf16* xparts = static_cast<bf16*>(parts);
  cudaError_t err;
  for (int i = 0; i < 7; ++i) launches[i] = 0;
  if (n_dots) {
    SplitParams sp;
    sp.r[0] = r0;
    sp.r[1] = r1;
    sp.r[2] = r2;
    sp.image = static_cast<unsigned char*>(image);
    sp.image_bytes = image_bytes(n);
    for (int d = 0; d < 3; ++d) sp.code[d] = codes[d];
    sp.n_dots = n_dots;
    sp.n = n;
    sp.kpad = kpad;
    sp.npad = npad;
    const long long total = (long long)n_dots * kpad * npad;
    wide_split_r_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(sp);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    launches[3] += 1;
  }
  for (int d = 0; d < n_dots; ++d) {
    err = cudaFuncSetAttribute(dot_for(codes[d]),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               dot_smem(codes[d]));
    if (err != cudaSuccess) return (int)err;
  }
  if (gram_code >= 0) {
    err = cudaFuncSetAttribute(gram_for(gram_code),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               gram_smem(gram_code));
    if (err != cudaSuccess) return (int)err;
  }
  const int esize = a_bf16 ? 2 : 4, qsize = q_bf16 ? 2 : 4;
  float* scr[2] = {scratch0, scratch1};
  for (long long c0 = 0; c0 < m; c0 += mc) {
    const long long rows = mc < m - c0 ? mc : m - c0;
    void* qc = write_q ? static_cast<char*>(q) + c0 * n * qsize : nullptr;
    const void* src = static_cast<const char*>(a) + c0 * n * esize;
    int sbf = a_bf16;
    for (int d = 0; d < n_dots; ++d) {
      const bool last = d == n_dots - 1;
      void* dst;
      int dbf;
      if (last && write_q && !(alias_q && n_dots == 1) &&
          (gram_code < 0 || !q_bf16)) {
        dst = qc;
        dbf = q_bf16;
      } else {
        dst = scr[d % 2];
        dbf = 0;
      }
      if (codes[d] > 0) {
        err = split_x(src, sbf, rows, n, codes[d], xparts, plane, st);
        if (err != cudaSuccess) return (int)err;
        launches[4] += 1;
      }
      DotParams p;
      p.src = src;
      p.parts = xparts;
      p.dst = dst;
      p.image = static_cast<const unsigned char*>(image) + d * image_bytes(n);
      p.rows = rows;
      p.plane = plane;
      p.n = n;
      p.kpad = kpad;
      p.npad = npad;
      p.src_bf16 = sbf;
      p.src_fast = src_fast(src, sbf, n);
      p.dst_bf16 = dbf;
      p.residual = res[d];
      dim3 grid;
      if (codes[d] == 0)
        grid = dim3((n + FN - 1) / FN, (unsigned)((rows + FM - 1) / FM));
      else
        grid = dim3((n + DN - 1) / DN, (unsigned)((rows + DM - 1) / DM));
      dot_for(codes[d])<<<grid, THREADS, dot_smem(codes[d]), st>>>(p);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      launches[codes[d] == 0 ? 5 : 0] += 1;
      src = dst;
      sbf = dbf;
    }
    if (gram_code >= 0) {
      if (gram_code > 0) {
        err = split_x(src, sbf, rows, n, gram_code, xparts, plane, st);
        if (err != cudaSuccess) return (int)err;
        launches[4] += 1;
      }
      GramParams p;
      p.src = src;
      p.parts = xparts;
      p.partials = partials;
      p.rows = rows;
      p.plane = plane;
      p.n = n;
      p.nbj = gram_nbj(n);
      p.kpad = kpad;
      p.src_bf16 = sbf;
      p.src_fast = src_fast(src, sbf, n);
      p.first = c0 == 0;
      const dim3 grid(gram_blocks(n), (unsigned)((rows + SLAB - 1) / SLAB));
      gram_for(gram_code)<<<grid, THREADS, gram_smem(gram_code), st>>>(p);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      launches[gram_code == 0 ? 6 : 1] += 1;
    }
    if (write_q && src != qc && !(alias_q && n_dots == 0)) {
      const long long count = rows * n;
      long long blocks = (count + 255) / 256;
      blocks = blocks < 4096 ? blocks : 4096;
      wide_store_kernel<<<(unsigned)blocks, 256, 0, st>>>(src, sbf, qc,
                                                         q_bf16, count);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      launches[2] += 1;
    }
  }
  return 0;
}

}  // extern "C"
