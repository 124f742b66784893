// Streaming pass over a tall-skinny A (m, n): up to three chained dots
// x <- x R_i (or x <- x + x D_i), an optional write of x to Q, and an
// optional Kahan-compensated half-Gram P of x (the caller forms
// G = P + P^T).  Every product runs at its own split mode: float32 parts
// (fp32), one bf16 part (bf16, bf16_nocor), two (bf16x3_*) or three
// (bf16x6_cor), with the products of each residual order summed together
// and the orders added smallest first, as the JAX package does.
//
// Replaces the Pallas kernel tsqr_tpu/ops/pallas_gram.py::stream_pallas
// (body `kernel`, helpers _mode_parts, _dot_mode, _gram_half).
//
// What bounds it on the H100: at n = 128 a bf16x6_cor pass does 6 (dot)
// or 4 (half-Gram) split products of 2 m n^2 flops each, about 1.5 flop
// per byte of A for each product.  On the tensor cores that is far below
// the ~295 flop/byte ridge, so the bound is the one read of A (and one
// write of Q).  The split products run as mma.sync m16n8k16 bf16 with
// float32 accumulation (a product of two bf16 values is exact); the fp32
// mode, which must not round its operands, runs float32 FMAs on the CUDA
// cores.  This version runs at ~25x the memory bound; its phase timers
// (harness/phase_profile.py) put the time in the per-tile update of the
// (n, n) Kahan pair in shared memory and the per-tile reload and split of
// R.  A coarser Kahan chunk, R kept resident, and TMA/wgmma are later work.
//
// Design against the TPU kernel:
// * The TPU grid runs its chunks in order into one resident accumulator.
//   Here each CTA owns a contiguous range of TM-row tiles, keeps its own
//   Kahan-compensated half-Gram in shared memory (each thread updates the
//   entries of its mma accumulator fragments), and writes it out as
//   float64 (sum minus compensation); stream_gram_reduce_kernel then adds
//   the CTA partials in a fixed order in float64.  No atomics: the result
//   is the same from run to run.
// * Kahan adds happen once per TM-row tile, so the Gram error is
//   chunk-local with chunk = TM (effective_chunk in gram_stream.py).
// * The ragged last tile and the columns past n are zero-filled in shared
//   memory: zero rows and columns add nothing to any product.
// * Bitwise recomputation: the compact CholeskyQR pipelines re-derive
//   x = A F in a later pass and rely on getting the same bits.  There is
//   one kernel, not one per configuration, and every sum order is fixed
//   (the same mma.sync sequence, explicit fmaf and __fadd_rn/__fsub_rn,
//   which nvcc never contracts or reorders), so a Gram-only launch and a
//   Q-writing launch with the same dots derive identical x.
// * In place (alias_q in gram_stream.py): the caller may pass q == a.
//   Each CTA owns the contiguous tiles t0..t1-1; it has every element of
//   tile t in registers (and then in shared memory) before it writes tile
//   t's Q, and it fetches tile t+1 before that write, so no row is written
//   before it is read and no other CTA touches those rows.  Hence p.a and
//   p.q carry no __restrict__.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "splits.cuh"  // n_parts, bf16_round, split_store, sum_orders

#define TM 16          // rows per tile (the Kahan granularity)
#define N_MAX 128      // widest n: bounds the shared-memory footprint
#define KS 16          // rows of R split into shared memory at a time
#define THREADS 256
#define MR 2           // dot micro-tile: MR rows x MC columns per thread
#define MC 4
// loads per thread for one tile or one R slab (TM = KS rows of sx floats)
#define LOADS ((TM * (N_MAX + 4) + THREADS - 1) / THREADS)
// row pairs per thread when splitting a tile for the Gram
#define PAIRS ((TM / 2 * (N_MAX + 8) + THREADS - 1) / THREADS)
static_assert(TM == KS, "a tile and an R slab share one load pattern");
static_assert(TM == 16, "a tile is one mma k-step of the half-Gram");
static_assert(N_MAX / 8 <= 2 * THREADS / 32, "two column tiles per warp");

// Phase timers, compiled in only with -DSTREAM_GRAM_PROFILE (see
// harness/phase_profile.py): thread 0 of each CTA adds the clock64() time
// since its previous mark to the phase that just ended.  Phases end at
// barriers, so a phase's time includes waiting for the slowest thread.
#define N_PHASES 10  // see PHASE_NAMES in harness/phase_profile.py
#define MAX_PROFILED_CTAS 1024
#ifdef STREAM_GRAM_PROFILE
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

struct Params {
  const void* a;
  const float* r[3];
  void* q;
  double* partials;
  long long m;
  long long tiles;
  int n, np, sx, sg, sk;  // width, padded width, shared-memory row strides
  int a_bf16, q_bf16, write_q, n_dots, gram_code;
  int dot_code[3];
  int residual[3];
};

// Shared-memory rows are padded against bank conflicts: the tile, its
// dot parts, Y and the R slab to sx = np + 4 words (the rows 2t of an mma
// fragment then fall on distinct banks); the Gram's row-pair words to
// sg = np + 8 (so do its rows t and t + 4); the Kahan pair to sk = np + 8
// (so do the row groups g of a float2 update).
static int row_sx(int np) { return np + 4; }
static int row_sg(int np) { return np + 8; }
static int row_sk(int np) { return np + 8; }

static size_t smem_floats(int np, int n_dots, int gram_code) {
  const size_t sx = row_sx(np), sg = row_sg(np);
  size_t f = 4 * TM * sx;                          // X + its dot parts
  if (n_dots) f += TM * sx + 3 * KS * sx;          // Y + parts of an R slab
  if (gram_code > 0) f += 3 * (TM / 2) * sg;       // Gram parts, row pairs
  if (gram_code >= 0) f += 2 * np * row_sk(np);    // Kahan sum + compensation
  return f;
}

// Two bf16-exact floats as one bf16x2 register (lo in the low half).
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += A B on the tensor cores: A 16x16 bf16 (row), B 16x8 bf16 (col),
// c 16x8 float32.  Fragment layout of mma.m16n8k16 (lane = 4 g + t):
// a = {(g, 2t..2t+1), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)},
// b = {(2t..2t+1, g), (2t+8..2t+9, g)}, c = {(g, 2t..2t+1), (g+8, ..)}.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The (row, column) of this thread's j-th element of a TM x sx tile (and
// of a KS x sx slab), row << 16 | column, or -1 past the end: computed once
// per launch, so no load loop divides.
__device__ __forceinline__ void load_pattern(int sx, int rc[LOADS]) {
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int idx = threadIdx.x + j * THREADS;
    rc[j] = idx < TM * sx ? (idx / sx) << 16 | (idx % sx) : -1;
  }
}

// Load and split rows k0 .. k0+KS-1 of R into RS (zero past n).  Every
// load is issued before the first is used, so a slab costs one round trip
// to L2 and not one per element.
__device__ __forceinline__ void load_r_slab(const float* R, int n, int sx,
                                            int k0, int code, float* RS,
                                            const int rc[LOADS]) {
  float v[LOADS];
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int k = k0 + (rc[j] >> 16), c = rc[j] & 0xffff;
    v[j] = (rc[j] >= 0 && k < n && c < n) ? R[(size_t)k * n + c] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < LOADS; ++j)
    if (rc[j] >= 0)
      split_store(v[j], code, RS + threadIdx.x + j * THREADS, KS * sx);
}

// Fetch rows tile*TM .. +TM-1 of A (zero past m and n) into registers;
// the loads complete while the current tile computes.
__device__ __forceinline__ void fetch_tile(const Params& p, long long tile,
                                           const int rc[LOADS],
                                           float v[LOADS]) {
  const float* a32 = static_cast<const float*>(p.a);
  const __nv_bfloat16* a16 = static_cast<const __nv_bfloat16*>(p.a);
#pragma unroll
  for (int j = 0; j < LOADS; ++j) {
    const int c = rc[j] & 0xffff;
    const long long g = tile * TM + (rc[j] >> 16);
    v[j] = 0.f;
    if (rc[j] >= 0 && g < p.m && c < p.n) {
      const size_t off = (size_t)g * p.n + c;
      v[j] = p.a_bf16 ? __bfloat162float(a16[off]) : a32[off];
    }
  }
}

// Y = X R at fp32 mode (one unrounded part) by float32 FMAs, for the
// thread's MR x MC micro-tile.  With dot_tile_mma, the only code that
// computes a dot: every launch derives x through them.
__device__ __forceinline__ void dot_tile(const Params& p, int d,
                                         const float* XP, float* Y,
                                         float* RS, const int rc[LOADS]) {
  const int np = p.np, sx = p.sx;
  const int cols = np / MC;
  const int mt = threadIdx.x;
  const bool active = mt < (TM / MR) * cols;
  const int r0 = (mt / cols) * MR, c0 = (mt % cols) * MC;
  float b[MR][MC];
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < MC; ++j) b[i][j] = 0.f;

  for (int k0 = 0; k0 < np; k0 += KS) {
    __syncthreads();  // XP complete; previous slab consumed
    load_r_slab(p.r[d], p.n, sx, k0, 0, RS, rc);
    __syncthreads();
    if (!active) continue;
    for (int kk = 0; kk < KS; ++kk) {
      float xv[MR], rv[MC];
#pragma unroll
      for (int i = 0; i < MR; ++i) xv[i] = XP[(r0 + i) * sx + k0 + kk];
#pragma unroll
      for (int j = 0; j < MC; ++j) rv[j] = RS[kk * sx + c0 + j];
#pragma unroll
      for (int i = 0; i < MR; ++i)
#pragma unroll
        for (int j = 0; j < MC; ++j) b[i][j] = fmaf(xv[i], rv[j], b[i][j]);
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < MR; ++i)
#pragma unroll
    for (int j = 0; j < MC; ++j) Y[(r0 + i) * sx + c0 + j] = b[i][j];
}

// The tile's half-Gram entry from its terms, smallest order first:
// order 0: 0.5 t0; order 1: t0 + 0.5 t1; order 2: ((t0 + 0.5 t1) + t2)
// + 0.5 t3, with the terms as gram_frag_mma lists them.
__device__ __forceinline__ float combine_terms(float t0, float t1, float t2,
                                              float t3, int order) {
  if (order == 0) return __fmul_rn(0.5f, t0);
  float c = __fadd_rn(t0, __fmul_rn(0.5f, t1));
  if (order == 1) return c;
  c = __fadd_rn(c, t2);
  return __fadd_rn(c, __fmul_rn(0.5f, t3));
}

// Kahan-compensated sum += c.
__device__ __forceinline__ void kahan(float c, float& sum, float& comp) {
  const float y = __fsub_rn(c, comp);
  const float s = __fadd_rn(sum, y);
  comp = __fsub_rn(__fsub_rn(s, sum), y);
  sum = s;
}

// The same for two neighbouring entries of the (KT, KC) pair in shared
// memory, one float2 access each.
__device__ __forceinline__ void kahan2(float c0, float c1, float* sum,
                                       float* comp) {
  float2 s = *reinterpret_cast<float2*>(sum);
  float2 k = *reinterpret_cast<float2*>(comp);
  kahan(c0, s.x, k.x);
  kahan(c1, s.y, k.y);
  *reinterpret_cast<float2*>(sum) = s;
  *reinterpret_cast<float2*>(comp) = k;
}

// Y = X R at a bf16-split mode (codes 1-3) on the tensor cores: each warp
// owns up to two 16x8 column tiles of Y; every product x_u r_w of residual
// order s accumulates into that order's float32 fragment.
__device__ __forceinline__ void dot_tile_mma(const Params& p, int d,
                                             const float* XP, float* Y,
                                             float* RS, const int rc[LOADS]) {
  const int np = p.np, sx = p.sx, code = p.dot_code[d];
  const int P = n_parts(code), order = P - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3, n_nt = np / 8;
  float acc[2][3][4];
#pragma unroll
  for (int jj = 0; jj < 2; ++jj)
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jj][s][e] = 0.f;

  for (int k0 = 0; k0 < np; k0 += KS) {
    __syncthreads();  // XP complete; previous slab consumed
    PHASE(2);
    load_r_slab(p.r[d], p.n, sx, k0, code, RS, rc);
    PHASE(3);
    __syncthreads();
    PHASE(4);
    uint32_t af[3][4];
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      if (q < P) {
        const float* x = XP + q * TM * sx + k0 + 2 * t;
        af[q][0] = pack2(x[g * sx], x[g * sx + 1]);
        af[q][1] = pack2(x[(g + 8) * sx], x[(g + 8) * sx + 1]);
        af[q][2] = pack2(x[g * sx + 8], x[g * sx + 9]);
        af[q][3] = pack2(x[(g + 8) * sx + 8], x[(g + 8) * sx + 9]);
      }
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int nt = warp + 8 * jj;
      if (nt >= n_nt) continue;
      uint32_t bf[3][2];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        if (q < P) {
          const float* r = RS + q * KS * sx + 2 * t * sx + nt * 8 + g;
          bf[q][0] = pack2(r[0], r[sx]);
          bf[q][1] = pack2(r[8 * sx], r[9 * sx]);
        }
      }
#pragma unroll
      for (int s = 0; s < 3; ++s)
#pragma unroll
        for (int u = 0; u < 3; ++u) {
          const int w = s - u;
          if (s <= order && u < P && w >= 0 && w < P)
            mma_bf16(acc[jj][s], af[u], bf[w]);
        }
    }
    PHASE(5);
  }
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int nt = warp + 8 * jj;
    if (nt >= n_nt) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + (e >= 2 ? 8 : 0), col = nt * 8 + 2 * t + (e & 1);
      Y[row * sx + col] =
          sum_orders(acc[jj][0][e], acc[jj][1][e], acc[jj][2][e], order);
    }
  }
}

// The (pair, column) of this thread's j-th row-pair word of a tile,
// pair << 16 | column, or -1 past the end (see load_pattern).
__device__ __forceinline__ void pair_pattern(int sg, int pc[PAIRS]) {
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    const int idx = threadIdx.x + j * THREADS;
    pc[j] = idx < TM / 2 * sg ? (idx / sg) << 16 | (idx % sg) : -1;
  }
}

// Split the tile X for a bf16 Gram mode into GP[q][i][c] = (part q of
// rows 2i and 2i+1 at column c) as one bf16x2 word: the operand layout of
// both fragments of the half-Gram's mma.  The split is split_store's.
__device__ __forceinline__ void split_pairs(const float* X, int sx, int sg,
                                            int code, uint32_t* GP,
                                            const int pc[PAIRS]) {
#pragma unroll
  for (int j = 0; j < PAIRS; ++j) {
    if (pc[j] < 0) continue;
    const int i = pc[j] >> 16, c = pc[j] & 0xffff, w = i * sg + c;
    const int part = TM / 2 * sg;
    const float v0 = X[2 * i * sx + c], v1 = X[(2 * i + 1) * sx + c];
    const float p0 = bf16_round(v0), q0 = bf16_round(v1);
    GP[w] = pack2(p0, q0);
    if (code >= 2) {
      const float r0 = __fsub_rn(v0, p0), r1 = __fsub_rn(v1, q0);
      const float p1 = bf16_round(r0), q1 = bf16_round(r1);
      GP[part + w] = pack2(p1, q1);
      if (code == 3)
        GP[2 * part + w] = pack2(bf16_round(__fsub_rn(r0, p1)),
                                 bf16_round(__fsub_rn(r1, q1)));
    }
  }
}

// The tile's half-Gram entries (a0 + g, b0 + 2t + {0, 1}) and
// (a0 + g + 8, ...), the layout of an mma accumulator, into c[4].
// fp32 mode: P = 0.5 x^T x by float32 FMAs over the tile's rows.
__device__ __forceinline__ void gram_frag_fp32(const float* X, int sx,
                                               int a0, int b0, int g, int t,
                                               float c[4]) {
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int r = 0; r < TM; ++r) {
    const float* x = X + r * sx;
    const float xa0 = x[a0 + g], xa1 = x[a0 + g + 8];
    const float xb0 = x[b0 + 2 * t], xb1 = x[b0 + 2 * t + 1];
    s[0] = fmaf(xa0, xb0, s[0]);
    s[1] = fmaf(xa0, xb1, s[1]);
    s[2] = fmaf(xa1, xb0, s[2]);
    s[3] = fmaf(xa1, xb1, s[3]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = combine_terms(s[e], 0.f, 0.f, 0.f, 0);
}

// bf16-split modes on the tensor cores: the tile's TM rows are one
// k-step, so each term x_u^T x_w is one mma, and the terms combine
// smallest order first.
__device__ __forceinline__ void gram_frag_mma(const uint32_t* GP, int sg,
                                              int order, int a0, int b0,
                                              int g, int t, float c[4]) {
  uint32_t af[2][4], bf[3][2];
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    if (q <= order) {
      const uint32_t* x = GP + q * (TM / 2) * sg;
      if (q < 2) {  // A = x_q^T: element (i, k) is x_q[k][a0 + i]
        af[q][0] = x[t * sg + a0 + g];
        af[q][1] = x[t * sg + a0 + g + 8];
        af[q][2] = x[(t + 4) * sg + a0 + g];
        af[q][3] = x[(t + 4) * sg + a0 + g + 8];
      }
      bf[q][0] = x[t * sg + b0 + g];
      bf[q][1] = x[(t + 4) * sg + b0 + g];
    }
  }
  float tm[4][4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int e = 0; e < 4; ++e) tm[k][e] = 0.f;
  if (order == 0) {
    mma_bf16(tm[0], af[0], bf[0]);
  } else if (order == 1) {  // terms (0,1), (0,0)
    mma_bf16(tm[0], af[0], bf[1]);
    mma_bf16(tm[1], af[0], bf[0]);
  } else {  // terms (0,2), (1,1), (0,1), (0,0)
    mma_bf16(tm[0], af[0], bf[2]);
    mma_bf16(tm[1], af[1], bf[1]);
    mma_bf16(tm[2], af[0], bf[1]);
    mma_bf16(tm[3], af[0], bf[0]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    c[e] = combine_terms(tm[0][e], tm[1][e], tm[2][e], tm[3][e], order);
}

// Kahan-add the tile's half-Gram into the CTA's (KT, KC); each thread
// updates the entries of its own accumulator fragments.
__device__ __forceinline__ void gram_tile(const Params& p, const float* X,
                                          const uint32_t* GP, float* KT,
                                          float* KC) {
  const int order = n_parts(p.gram_code) - 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  for (int a0 = 0; a0 < p.np; a0 += 16) {
    for (int nt = warp; nt < p.np / 8; nt += THREADS / 32) {
      float c[4];
      if (p.gram_code == 0)
        gram_frag_fp32(X, p.sx, a0, 8 * nt, g, t, c);
      else
        gram_frag_mma(GP, p.sg, order, a0, 8 * nt, g, t, c);
      const int e0 = (a0 + g) * p.sk + 8 * nt + 2 * t, e1 = e0 + 8 * p.sk;
      kahan2(c[0], c[1], KT + e0, KC + e0);
      kahan2(c[2], c[3], KT + e1, KC + e1);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
stream_gram_kernel(Params p) {
  extern __shared__ float smem[];
  const int n = p.n, sx = p.sx;
  float* X = smem;
  float* XP = X + TM * sx;
  float* base = XP + 3 * TM * sx;
  float *Y = nullptr, *RS = nullptr;
  if (p.n_dots) {
    Y = base;
    RS = Y + TM * sx;
    base = RS + 3 * KS * sx;
  }
  uint32_t* GP = reinterpret_cast<uint32_t*>(base);
  if (p.gram_code > 0) base += 3 * (TM / 2) * p.sg;
  const bool gram = p.gram_code >= 0;
  float* KT = base;
  float* KC = KT + p.np * p.sk;
  if (gram)
    for (int e = threadIdx.x; e < p.np * p.sk; e += THREADS) KT[e] = KC[e] = 0.f;
  int pc[PAIRS];
  pair_pattern(p.sg, pc);
#ifdef STREAM_GRAM_PROFILE
  if (threadIdx.x == 0) {
    for (int k = 0; k < N_PHASES; ++k) phase_cycles[k] = 0;
    phase_mark = clock64();
  }
#endif
  const long long t0 = blockIdx.x * p.tiles / gridDim.x;
  const long long t1 = (blockIdx.x + 1) * p.tiles / gridDim.x;
  int rc[LOADS];
  load_pattern(sx, rc);
  float next[LOADS];
  fetch_tile(p, t0, rc, next);

  for (long long tile = t0; tile < t1; ++tile) {
    const long long row0 = tile * TM;
    __syncthreads();  // the previous tile is done with X and XP
    PHASE(0);
#pragma unroll
    for (int j = 0; j < LOADS; ++j) {
      const int idx = threadIdx.x + j * THREADS;
      if (idx < TM * sx) X[idx] = next[j];
    }
    if (tile + 1 < t1) fetch_tile(p, tile + 1, rc, next);
    PHASE(1);
    for (int d = 0; d < p.n_dots; ++d) {
      __syncthreads();  // X complete
      for (int idx = threadIdx.x; idx < TM * sx; idx += THREADS)
        split_store(X[idx], p.dot_code[d], XP + idx, TM * sx);
      if (p.dot_code[d] == 0)
        dot_tile(p, d, XP, Y, RS, rc);
      else
        dot_tile_mma(p, d, XP, Y, RS, rc);
      __syncthreads();  // Y complete
      for (int idx = threadIdx.x; idx < TM * sx; idx += THREADS)
        X[idx] = p.residual[d] ? __fadd_rn(X[idx], Y[idx]) : Y[idx];
    }
    __syncthreads();  // final X complete
    PHASE(6);
    if (p.write_q) {
#pragma unroll
      for (int j = 0; j < LOADS; ++j) {
        const int idx = threadIdx.x + j * THREADS, c = rc[j] & 0xffff;
        const long long g = row0 + (rc[j] >> 16);
        if (rc[j] >= 0 && g < p.m && c < n) {
          const size_t off = (size_t)g * n + c;
          if (p.q_bf16)
            static_cast<__nv_bfloat16*>(p.q)[off] = __float2bfloat16_rn(X[idx]);
          else
            static_cast<float*>(p.q)[off] = X[idx];
        }
      }
      PHASE(7);
    }
    if (gram) {
      if (p.gram_code > 0) {
        split_pairs(X, sx, p.sg, p.gram_code, GP, pc);
        __syncthreads();
        PHASE(8);
      }
      gram_tile(p, X, GP, KT, KC);
      PHASE(9);
    }
  }
#ifdef STREAM_GRAM_PROFILE
  if (threadIdx.x == 0 && blockIdx.x < MAX_PROFILED_CTAS)
    for (int k = 0; k < N_PHASES; ++k)
      g_phase_cycles[blockIdx.x * N_PHASES + k] = phase_cycles[k];
#endif
  if (gram) {  // this CTA's partial: sum minus compensation, in float64
    __syncthreads();
    double* out = p.partials + (size_t)blockIdx.x * n * n;
    for (int e = threadIdx.x; e < n * n; e += THREADS) {
      const int a = e / n, b = e % n;
      out[e] = (double)KT[a * p.sk + b] - (double)KC[a * p.sk + b];
    }
  }
}

// out[e] = sum over CTAs b = 0, 1, ... of partials[b][e], in float64.
__global__ void stream_gram_reduce_kernel(const double* partials, float* out,
                                          int grid, int nn) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= nn) return;
  double s = 0.0;
  for (int b = 0; b < grid; ++b) s += partials[(size_t)b * nn + e];
  out[e] = (float)s;
}

// columns held in shared memory: n rounded up to whole mma k-steps
static int round_np(int n) { return (n + 15) / 16 * 16; }

extern "C" {

int stream_gram_tile_rows(void) { return TM; }

#ifdef STREAM_GRAM_PROFILE
// Copy the last launch's phase cycles, (MAX_PROFILED_CTAS, N_PHASES)
// int64, to the host.
int stream_gram_phase_cycles(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_phase_cycles,
                                   sizeof(long long) * MAX_PROFILED_CTAS *
                                       N_PHASES);
}
#endif
int stream_gram_n_max(void) { return N_MAX; }

// CTAs for a launch: as many as fit on the card at once, at most one per
// tile.  The float64 partials buffer has one (n, n) slab per CTA.
int stream_gram_grid(long long m, int n, int n_dots, int gram_code,
                     int* grid) {
  if (n < 1 || n > N_MAX || m < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_floats(round_np(n), n_dots, gram_code) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      stream_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, stream_gram_kernel, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (m + TM - 1) / TM;
  const long long g = (long long)per_sm * sms;
  *grid = (int)(tiles < g ? tiles : g);
  return 0;
}

int stream_gram_launch(const void* a, int a_bf16, const float* r0,
                       const float* r1, const float* r2, int n_dots,
                       int code0, int code1, int code2, int res0, int res1,
                       int res2, void* q, int q_bf16, int write_q,
                       int gram_code, double* partials, long long m, int n,
                       int grid, void* stream) {
  const int codes[3] = {code0, code1, code2};
  for (int d = 0; d < n_dots; ++d)
    if (codes[d] < 0 || codes[d] > 3) return (int)cudaErrorInvalidValue;
  if (n < 1 || n > N_MAX || n_dots < 0 || n_dots > 3 || grid < 1 ||
      gram_code > 3 || (!write_q && gram_code < 0))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.a = a;
  p.r[0] = r0;
  p.r[1] = r1;
  p.r[2] = r2;
  p.q = q;
  p.partials = partials;
  p.m = m;
  p.tiles = (m + TM - 1) / TM;
  p.n = n;
  p.np = round_np(n);
  p.sx = row_sx(p.np);
  p.sg = row_sg(p.np);
  p.sk = row_sk(p.np);
  p.a_bf16 = a_bf16;
  p.q_bf16 = q_bf16;
  p.write_q = write_q;
  p.n_dots = n_dots;
  p.gram_code = gram_code;
  p.dot_code[0] = code0;
  p.dot_code[1] = code1;
  p.dot_code[2] = code2;
  p.residual[0] = res0;
  p.residual[1] = res1;
  p.residual[2] = res2;
  const size_t smem = smem_floats(p.np, n_dots, gram_code) * 4;
  cudaError_t err = cudaFuncSetAttribute(
      stream_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  stream_gram_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

int stream_gram_reduce(const double* partials, float* out, int grid, int nn,
                       void* stream) {
  const int threads = 256;
  stream_gram_reduce_kernel<<<(nn + threads - 1) / threads, threads, 0,
                              (cudaStream_t)stream>>>(partials, out, grid,
                                                      nn);
  return (int)cudaGetLastError();
}

}  // extern "C"
