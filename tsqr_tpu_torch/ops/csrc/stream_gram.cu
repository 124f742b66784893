// Streaming pass over a tall-skinny A (m, n), n <= 128: up to three
// chained dots x <- x R_i (or x <- x + x R_i), an optional write of x to
// Q, and an optional compensated half-Gram P of x (the caller forms
// G = P + P^T).  Every product runs at its own split mode: float32 parts
// (fp32), one bf16 part (bf16, bf16_nocor), two (bf16x3_*) or three
// (bf16x6_cor), the products of each residual order summed together and
// the orders added smallest first, as the JAX package does.
//
// Replaces the Pallas kernel tsqr_tpu/ops/pallas_gram.py::stream_pallas
// (body `kernel`, helpers _mode_parts, _dot_mode, _gram_half);
// stream_gram_reduce_kernel replaces its sequential accumulator across
// grid steps (pallas_gram.py:280-288).
//
// What bounds it on the H100.  At n = 128 a bf16x6_cor pass does 6 (dot)
// or 4 (half-Gram) split products of 2 m n^2 flops each.  The tier-1
// Gram + Q pass at (2^20, 128) moves 1.5 GiB (0.48 ms at 3.35 TB/s) and
// does 344 GFLOP of bf16 products (0.35 ms at 989 TFLOP/s): bytes and
// products are nearly balanced, so both are designed for.
//
// Design:
// * Gram sums in registers over a chunk of CHUNK rows.  Each warp keeps
//   its 32 x 32 block of P in float32 mma fragments, one per residual
//   order (order 2 holds x0^T (2 x2) + x1^T x1, halved at the fold; the
//   0.5 of the diagonal terms is a power of two and exact), over every
//   16-row k-step of the chunk.  Once per chunk the warp folds the orders
//   smallest first and adds the result into its CTA's float64 partial in
//   device memory, each thread on its own entries.  x6 needs
//   3 x 128 x 128 float32 accumulators, more than one CTA's registers, so
//   two CTAs share each row range (a pair, launched as a cluster of 2):
//   CTA h of the pair owns P's columns [64 h, 64 h + 64), 96 accumulator
//   registers a thread.  Both read the same rows (the second read is an
//   L2 hit) and both form x, so a Gram call's dots run twice.
// * R split once.  A prologue kernel splits each factor into its parts
//   (bf16, or float32 for fp32) once per launch, in the layout of the
//   shared-memory image; each CTA copies the images into shared memory
//   once and keeps them for the whole launch.  Chained factors that do
//   not fit together are copied per tile from L2, never split again.
// * A through an asynchronous ring of 2-5 shared-memory slots fed by
//   cp.async: 16-byte copies, zero-filled past m and n (4-byte copies
//   where a row is not 16-byte aligned; a bf16 A is loaded and widened at
//   once).  Tile t + S - 1 is in flight while tile t is computed.  One
//   bulk (TMA) copy a row, completing on an mbarrier, was tried and
//   measured slower (PERF.md); a tensor map is not needed at this width.
//   Q leaves through 16-byte stores from the slot.
// * Calls without a Gram run each CTA as two teams of four warps, each
//   with its own ring and parts on alternate 32-row halves of the tiles,
//   so that one team's splits and stores overlap the other's products.
// * Tensor cores: the bf16 split products run as mma.sync m16n8k16 with
//   ldmatrix from padded shared memory (rows of 136 bf16: conflict-free).
//   wgmma is not used yet: this is the stated mma.sync step, its time in
//   PERF.md.  The fp32 mode, which must not round its operands, runs
//   float32 FMAs on the CUDA cores.
// * Bitwise recomputation: the compact CholeskyQR pipelines re-derive
//   x = A F in a later pass and rely on the same bits.  Every launch
//   derives x through the same dot code (dot_mma / dot_fp32: a fixed
//   mma.sync and fmaf sequence, explicit __fadd_rn), and every Gram call
//   cuts m into the same chunks and CTA ranges (they depend on m alone),
//   so a Gram-only and a Q-writing launch with the same dots agree.
// * The float64 partials are summed by stream_gram_reduce_kernel in a
//   fixed order (eight groups of partials, then the groups in order): no
//   atomics, the same bits every run.
// * In place (alias_q in gram_stream.py): the caller may pass q == a.
//   Each CTA (or pair) owns a contiguous row range and writes tile t's Q
//   only after tile t is in its shared memory; a pair's partner may still
//   be reading tile t, so with alias_q a Gram call's pair meets at a
//   cluster barrier (arrive once its tile is read, wait before the
//   write).  p.a and p.q carry no __restrict__.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "splits.cuh"  // n_parts, bf16_round, sum_orders

#define TM 64            // rows per tile (one ring slot)
#define CHUNK 4096       // most rows a Gram sums in registers before a fold
#define TPC (CHUNK / TM) // tiles per chunk
#define NP 128           // every tile is processed at the widest n
#define THREADS 256
#define XS 132           // float32 row stride (words) of a slot
#define BS 136           // bf16 row stride (elements) of a part
#define SLOT_BYTES (TM * XS * 4)
#define PART_BYTES (TM * BS * 2)
#define PARTS_BYTES (3 * PART_BYTES)
#define RPART_BYTES (NP * BS * 2)
#define RF32_BYTES (NP * XS * 4)
#define R_IMAGE_MAX (3 * RPART_BYTES)
#define SMEM_MAX (226 * 1024)  // of 227 KiB: room for static shared memory
#define MAX_SLOTS 5
static_assert(CHUNK % TM == 0, "a chunk is whole tiles");
static_assert(RF32_BYTES <= R_IMAGE_MAX, "an fp32 image fits its slot");
static_assert(TM * XS * 4 <= PARTS_BYTES, "an fp32 copy fits the parts");

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

typedef __nv_bfloat16 bf16;

struct Params {
  const void* a;
  const unsigned char* r_image;  // dot d's image at d * R_IMAGE_MAX
  void* q;
  double* partials;
  long long m, tiles;
  int n, a_bf16, q_bf16, write_q, n_dots;
  int a_fast, q_fast;   // 16-byte rows: 16-byte copies and stores
  int slots, r_resident, alias_sync;
  int dot_code[3], residual[3], r_off[3];  // r_off: smem offset of image
};

struct SplitParams {
  const float* r[3];
  unsigned char* image;
  int code[3], n_dots, n;
};

__host__ __device__ inline int image_bytes(int code) {
  return code == 0 ? RF32_BYTES : (code <= 1 ? 1 : code) * RPART_BYTES;
}

// The 32 bits of a bf16 pair.
__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// a[d] with d a run-time index, without copying the kernel parameter to
// local memory
__device__ __forceinline__ int pick(const int a[3], int d) {
  return d == 0 ? a[0] : (d == 1 ? a[1] : a[2]);
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

// Wait until at most slots - 1 groups are pending: tile i has landed.
__device__ __forceinline__ void cp_wait_ring(int slots) {
  if (slots >= 4)
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  else if (slots == 3)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A barrier of one team of warps: the whole CTA (TEAMS = 1, barrier 0)
// or warps 4 k .. 4 k + 3 (TEAMS = 2, named barrier 1 + k).
template <int TEAMS>
__device__ __forceinline__ void team_sync(int team) {
  if constexpr (TEAMS == 1)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + team), "n"(THREADS / TEAMS)
                 : "memory");
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
                                         const uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragments of two neighbouring n8 tiles (k0 .. k0+15, n0 .. n0+15)
// of a [k][n] bf16 array with row stride BS: b[j][0..1] for tile j.
__device__ __forceinline__ void load_b2(uint32_t b[2][2], const bf16* base,
                                        int k0, int n0, int lane) {
  uint32_t t[4];
  ldsm_x4_t(t, base + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * BS + n0 +
                   (lane >> 4) * 8);
  b[0][0] = t[0];
  b[0][1] = t[1];
  b[1][0] = t[2];
  b[1][1] = t[3];
}

// ---------------------------------------------------------------------
// R: the prologue split, once per launch, into the shared-memory images.

__global__ void stream_gram_split_r_kernel(SplitParams sp) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= sp.n_dots * NP * NP) return;
  const int d = idx / (NP * NP), k = (idx / NP) % NP, c = idx % NP;
  const float v = (k < sp.n && c < sp.n) ? sp.r[d][k * sp.n + c] : 0.f;
  unsigned char* img = sp.image + (size_t)d * R_IMAGE_MAX;
  const int code = sp.code[d];
  if (code == 0) {
    reinterpret_cast<float*>(img)[k * XS + c] = v;
    return;
  }
  bf16* parts = reinterpret_cast<bf16*>(img);
  float p[3];
  split_parts(v, code, p);
  for (int q = 0; q < n_parts(code); ++q)
    parts[q * NP * BS + k * BS + c] = __float2bfloat16_rn(p[q]);
}

// Copy bytes (a multiple of 16) from device memory into shared memory.
__device__ __forceinline__ void copy_image(unsigned char* dst,
                                           const unsigned char* src,
                                           int bytes) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* t = reinterpret_cast<uint4*>(dst);
  for (int i = threadIdx.x; i < bytes / 16; i += THREADS) t[i] = s[i];
}

// ---------------------------------------------------------------------
// A: the ring.

// Start the copy of ROWS rows from row0 into `slot` (zero past m and
// n), by the NT threads of a team.  A float32 A goes by cp.async (16
// bytes a copy where rows are 16-byte aligned, else 4); a bf16 A is
// loaded and widened to float32 at once (the slot is free when its load
// is issued).
template <int ROWS, int NT>
__device__ __forceinline__ void issue_tile(const Params& p, long long row0,
                                           float* slot, int tid) {
  const int n = p.n;
  if (p.a_bf16) {
    const bf16* a = static_cast<const bf16*>(p.a);
    if (p.a_fast) {  // eight bf16 a 16-byte load
#pragma unroll
      for (int it = 0; it < ROWS * NP / 8 / NT; ++it) {
        const int i = tid + it * NT;
        const int r = i >> 4, c = (i & 15) * 8;
        const long long g = row0 + r;
        uint4 u = make_uint4(0, 0, 0, 0);
        if (g < p.m && c < n) u = *reinterpret_cast<const uint4*>(a + g * n + c);
        // a bf16 is the high half of its float32
        *reinterpret_cast<float4*>(slot + r * XS + c) = make_float4(
            __uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
            __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
        *reinterpret_cast<float4*>(slot + r * XS + c + 4) = make_float4(
            __uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
            __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
      }
    } else {  // rows not 16-byte aligned
      for (int i = tid; i < ROWS * NP; i += NT) {
        const int r = i >> 7, c = i & (NP - 1);
        const long long g = row0 + r;
        slot[r * XS + c] =
            (g < p.m && c < n) ? __bfloat162float(a[g * n + c]) : 0.f;
      }
    }
  } else {
    const float* a = static_cast<const float*>(p.a);
    if (p.a_fast) {
#pragma unroll
      for (int it = 0; it < ROWS * NP / 4 / NT; ++it) {
        const int i = tid + it * NT;
        const int r = i >> 5, c = (i & 31) * 4;
        const long long g = row0 + r;
        const bool in = g < p.m && c < n;
        cp_async16(slot + r * XS + c, in ? a + g * n + c : a, in ? 16 : 0);
      }
    } else {
      for (int i = tid; i < ROWS * NP; i += NT) {
        const int r = i >> 7, c = i & (NP - 1);
        const long long g = row0 + r;
        const bool in = g < p.m && c < n;
        cp_async4(slot + r * XS + c, in ? a + g * n + c : a, in ? 4 : 0);
      }
    }
  }
}

// ---------------------------------------------------------------------
// Splits of x (the slot) into the parts buffer.

// The parts of x for a dot (code 1-3: x0, x1, x2 as split_parts forms
// them) or, with GRAM, for the half-Gram (x0, x1, 2 x2: the order-2
// terms x0^T (2 x2) + x1^T x1 are halved at the fold).  Code 0 copies x.
template <bool GRAM, int ROWS, int NT>
__device__ __forceinline__ void split_x(const float* X, bf16* parts,
                                        int code, int h, int tid) {
#pragma unroll
  for (int it = 0; it < ROWS * NP / 4 / NT; ++it) {
    const int i = tid + it * NT;
    const int r = i >> 5, c = (i & 31) * 4;
    const float4 v = *reinterpret_cast<const float4*>(X + r * XS + c);
    if (code == 0) {
      *reinterpret_cast<float4*>(reinterpret_cast<float*>(parts) + r * XS +
                                 c) = v;
      continue;
    }
    // split_parts' arithmetic, two values a conversion: p0 = bf16(v),
    // p1 = bf16(v - p0), p2 = bf16((v - p0) - p1)
    __nv_bfloat162 w[3][2];
    const float2 x2[2] = {make_float2(v.x, v.y), make_float2(v.z, v.w)};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      w[0][e] = __float22bfloat162_rn(x2[e]);
      if (code >= 2) {
        const float2 f0 = __bfloat1622float2(w[0][e]);
        const float2 r0 = make_float2(__fsub_rn(x2[e].x, f0.x),
                                      __fsub_rn(x2[e].y, f0.y));
        w[1][e] = __float22bfloat162_rn(r0);
        if (code == 3 && !(GRAM && (c >> 6) != h)) {
          const float2 f1 = __bfloat1622float2(w[1][e]);
          w[2][e] = __float22bfloat162_rn(make_float2(
              __fsub_rn(r0.x, f1.x), __fsub_rn(r0.y, f1.y)));
          if (GRAM)  // 2 x2, exact in bf16
            w[2][e] = __hmul2(w[2][e], __float2bfloat162_rn(2.f));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      if (q >= n_parts(code)) break;
      // the Gram reads x2 only on its B side: this CTA's column half
      if (GRAM && q == 2 && (c >> 6) != h) break;
      const uint2 u = make_uint2(bits(w[q][0]), bits(w[q][1]));
      *reinterpret_cast<uint2*>(parts + q * ROWS * BS + r * BS + c) = u;
    }
  }
}

// ---------------------------------------------------------------------
// Dots.  With dot_fp32, the only code that computes a dot: every launch
// derives x through them.

// x <- y (or x + y), y = x R at a bf16 split mode (CODE 1-3) on the
// tensor cores; every product x_u r_v of residual order s accumulates
// into that order's float32 fragment.  A warp of a team of TW computes
// MT m16 tiles of rows by 32 columns at a time: MT = 2 where the
// registers allow (no Gram), MT = 1 (two 32-column pieces) beside the
// Gram's accumulators.  Each element sees the same mma sequence either
// way (k-steps in order, then orders, then terms), so every call kind
// derives the same x.
template <int CODE, int MT, int ROWS, int TW>
__device__ __forceinline__ void dot_mma(const bf16* XP, const bf16* RP,
                                        float* X, int residual, int warp,
                                        int lane) {
  constexpr int P = CODE <= 1 ? 1 : CODE, ORDER = P - 1;
  constexpr int RB = ROWS / (16 * MT), PIECES = NP / 32 / (TW / RB);
  static_assert(RB * (TW / RB) == TW && PIECES >= 1, "warps tile the rows");
  const int g = lane >> 2, t = lane & 3, r0 = 16 * MT * (warp % RB);
#pragma unroll 1
  for (int piece = 0; piece < PIECES; ++piece) {
    const int n0 = (warp / RB) * 32 * PIECES + piece * 32;
    float acc[3][MT][4][4];
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[s][i][j][e] = 0.f;
#pragma unroll 2
    for (int k0 = 0; k0 < NP; k0 += 16) {
      uint32_t af[3][MT][4], bf[3][4][2];
#pragma unroll
      for (int q = 0; q < P; ++q) {
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldsm_x4(af[q][i], XP + q * ROWS * BS +
                                (r0 + 16 * i + (lane & 15)) * BS + k0 +
                                (lane >> 4) * 8);
        load_b2(&bf[q][0], RP + q * NP * BS, k0, n0, lane);
        load_b2(&bf[q][2], RP + q * NP * BS, k0, n0 + 16, lane);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int s = 0; s <= ORDER; ++s)
#pragma unroll
            for (int u = 0; u < P; ++u) {
              const int v = s - u;
              if (v >= 0 && v < P)
                mma_bf16(acc[s][i][j], af[u][i], bf[v][j][0], bf[v][j][1]);
            }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r0 + 16 * i + g + (e >= 2 ? 8 : 0);
          const int col = n0 + 8 * j + 2 * t + (e & 1);
          const float y = sum_orders(acc[0][i][j][e], acc[1][i][j][e],
                                     acc[2][i][j][e], ORDER);
          float* xp = X + row * XS + col;
          *xp = residual ? __fadd_rn(*xp, y) : y;
        }
  }
}

// The same at fp32 mode (one unrounded part) by float32 FMAs, k in
// order: each thread owns a 4 x 8 block of the tile.  XP is x's float32
// copy, RF the float32 image of R.
template <int ROWS, int NT>
__device__ __forceinline__ void dot_fp32(const float* XP, const float* RF,
                                         float* X, int residual, int tid) {
  static_assert(NT / 16 * 4 == ROWS, "4 x 8 blocks tile the rows");
  const int r0 = (tid >> 4) * 4, c0 = (tid & 15) * 8;
  float b[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) b[i][j] = 0.f;
#pragma unroll 4
  for (int k = 0; k < NP; ++k) {
    const float4 ra = *reinterpret_cast<const float4*>(RF + k * XS + c0);
    const float4 rc = *reinterpret_cast<const float4*>(RF + k * XS + c0 + 4);
    const float rv[8] = {ra.x, ra.y, ra.z, ra.w, rc.x, rc.y, rc.z, rc.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float xv = XP[(r0 + i) * XS + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[i][j] = fmaf(xv, rv[j], b[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float* xp = X + (r0 + i) * XS + c0 + j;
      *xp = residual ? __fadd_rn(*xp, b[i][j]) : b[i][j];
    }
}

// One dot on the team's tile: split x, then its products.
template <int MT, int TEAMS>
__device__ __forceinline__ void run_dot(const Params& p, int d,
                                        const unsigned char* R, bf16* parts,
                                        float* X, int team) {
  constexpr int TW = 8 / TEAMS, NT = 32 * TW, ROWS = TM / TEAMS;
  const int tid = threadIdx.x % NT, warp = (threadIdx.x / 32) % TW;
  const int lane = threadIdx.x % 32, code = pick(p.dot_code, d);
  const int res = pick(p.residual, d);
  split_x<false, ROWS, NT>(X, parts, code, 0, tid);
  team_sync<TEAMS>(team);  // parts complete
  PHASE(3);
  const bf16* RP = reinterpret_cast<const bf16*>(R);
  if (code == 0)
    dot_fp32<ROWS, NT>(reinterpret_cast<const float*>(parts),
                       reinterpret_cast<const float*>(R), X, res, tid);
  else if (code == 1)
    dot_mma<1, MT, ROWS, TW>(parts, RP, X, res, warp, lane);
  else if (code == 2)
    dot_mma<2, MT, ROWS, TW>(parts, RP, X, res, warp, lane);
  else
    dot_mma<3, MT, ROWS, TW>(parts, RP, X, res, warp, lane);
  team_sync<TEAMS>(team);  // x complete; parts and R free
  PHASE(4);
}

// ---------------------------------------------------------------------
// The half-Gram over a chunk, in registers.

// Accumulate the tile's half-Gram into the warp's fragments: P rows
// 32 (w % 4) .. +31, columns 64 h + 32 (w / 4) .. +31.  Buckets: [0]
// x0^T x0, [1] x0^T x1, [2] x0^T (2 x2) + x1^T x1.
template <int GCODE>
__device__ __forceinline__ void gram_mma(const bf16* GP, int h,
                                         float acc[3][2][4][4]) {
  constexpr int NA = GCODE == 3 ? 2 : 1, NB = GCODE <= 1 ? 1 : GCODE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int a0 = 32 * (warp & 3), b0 = 64 * h + 32 * (warp >> 2);
#pragma unroll
  for (int k0 = 0; k0 < TM; k0 += 16) {
    uint32_t af[2][2][4], bf[3][2][2];
#pragma unroll
    for (int q = 0; q < NA; ++q)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm_x4_t(af[q][i], GP + q * TM * BS +
                                (k0 + (lane & 7) + (lane >> 4) * 8) * BS +
                                a0 + 16 * i + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {  // two n8 tiles of B at a time
#pragma unroll
      for (int q = 0; q < NB; ++q)
        load_b2(bf[q], GP + q * TM * BS, k0, b0 + 16 * jj, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int jl = 0; jl < 2; ++jl) {
          float* a0c = acc[0][i][2 * jj + jl];
          if (GCODE == 3) {
            mma_bf16(acc[2][i][2 * jj + jl], af[0][i], bf[2][jl][0],
                     bf[2][jl][1]);
            mma_bf16(acc[2][i][2 * jj + jl], af[1][i], bf[1][jl][0],
                     bf[1][jl][1]);
          }
          if (GCODE >= 2)
            mma_bf16(acc[1][i][2 * jj + jl], af[0][i], bf[1][jl][0],
                     bf[1][jl][1]);
          // order 0 carries G's magnitude: each k-step's products start
          // from zero and join the chunk's sum by a rounded add, so the
          // tensor core's accumulation rounding is not repeated over the
          // chunk
          float t0[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(t0, af[0][i], bf[0][jl][0], bf[0][jl][1]);
#pragma unroll
          for (int e = 0; e < 4; ++e) a0c[e] = __fadd_rn(a0c[e], t0[e]);
        }
    }
  }
}

// fp32: P rows 4 (tid / 8) .. +3, columns 64 h + 8 (tid % 8) .. +7, by
// float32 FMAs over the tile's rows in order.
__device__ __forceinline__ void gram_fp32(const float* X, int h,
                                          float s[4][8]) {
  const int a0 = 4 * (threadIdx.x >> 3), b0 = 64 * h + 8 * (threadIdx.x & 7);
#pragma unroll 4
  for (int k = 0; k < TM; ++k) {
    const float4 xa = *reinterpret_cast<const float4*>(X + k * XS + a0);
    const float4 xb = *reinterpret_cast<const float4*>(X + k * XS + b0);
    const float4 xc = *reinterpret_cast<const float4*>(X + k * XS + b0 + 4);
    const float va[4] = {xa.x, xa.y, xa.z, xa.w};
    const float vb[8] = {xb.x, xb.y, xb.z, xb.w, xc.x, xc.y, xc.z, xc.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = fmaf(va[i], vb[j], s[i][j]);
  }
}

// Add a folded chunk entry c at (row, col) into the CTA's float64
// partial: `old` is the entry read before (callers read a batch of
// entries first, so that the reads are in flight together).
__device__ __forceinline__ double read_entry(const double* part, int n,
                                             int row, int col, bool first) {
  return (row < n && col < n && !first) ? part[(size_t)row * n + col] : 0.0;
}

__device__ __forceinline__ void write_entry(double* part, int n, int row,
                                            int col, double old, float c) {
  if (row < n && col < n) part[(size_t)row * n + col] = old + (double)c;
}

// The chunk's fold: orders smallest first, into the partial; then zero.
template <int GCODE>
__device__ __forceinline__ void fold_mma(double* part, int n, int h,
                                         bool first, float acc[3][2][4][4]) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int a0 = 32 * (warp & 3), b0 = 64 * h + 32 * (warp >> 2);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    double old[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        old[j][e] = read_entry(part, n, a0 + 16 * i + g + (e >= 2 ? 8 : 0),
                               b0 + 8 * j + 2 * t + (e & 1), first);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float h0 = __fmul_rn(0.5f, acc[0][i][j][e]);
        float c;
        if (GCODE == 3)
          c = __fadd_rn(__fadd_rn(__fmul_rn(0.5f, acc[2][i][j][e]),
                                  acc[1][i][j][e]),
                        h0);
        else if (GCODE == 2)
          c = __fadd_rn(acc[1][i][j][e], h0);
        else
          c = h0;
        write_entry(part, n, a0 + 16 * i + g + (e >= 2 ? 8 : 0),
                    b0 + 8 * j + 2 * t + (e & 1), old[j][e], c);
#pragma unroll
        for (int s = 0; s < 3; ++s) acc[s][i][j][e] = 0.f;
      }
  }
}

__device__ __forceinline__ void fold_fp32(double* part, int n, int h,
                                          bool first, float s[4][8]) {
  const int a0 = 4 * (threadIdx.x >> 3), b0 = 64 * h + 8 * (threadIdx.x & 7);
#pragma unroll
  for (int i = 0; i < 4; i += 2) {
    double old[2][8];
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        old[k][j] = read_entry(part, n, a0 + i + k, b0 + j, first);
#pragma unroll
    for (int k = 0; k < 2; ++k)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        write_entry(part, n, a0 + i + k, b0 + j, old[k][j],
                    __fmul_rn(0.5f, s[i + k][j]));
        s[i + k][j] = 0.f;
      }
  }
}

// ---------------------------------------------------------------------
// Q.

// Write the tile's x to Q, rows below m: all columns, or with HALF
// those of CTA h of a pair, [64 h, 64 h + 64).  16-byte stores where the
// rows are 16-byte aligned.
template <bool HALF, int ROWS, int NT>
__device__ __forceinline__ void write_q(const Params& p, const float* X,
                                        long long row0, int h, int tid) {
  const int n = p.n, c_lo = HALF ? 64 * h : 0;
  constexpr int W = HALF ? 64 : NP;  // columns this CTA writes
  if (p.q_fast && !p.q_bf16) {  // float4 stores
#pragma unroll
    for (int it = 0; it < ROWS * W / 4 / NT; ++it) {
      const int i = tid + it * NT;
      const int r = i / (W / 4), c = c_lo + (i % (W / 4)) * 4;
      const long long g = row0 + r;
      if (g < p.m && c < n)
        *reinterpret_cast<float4*>(static_cast<float*>(p.q) + g * n + c) =
            *reinterpret_cast<const float4*>(X + r * XS + c);
    }
  } else if (p.q_fast) {  // eight bf16 a 16-byte store
#pragma unroll
    for (int it = 0; it < ROWS * W / 8 / NT; ++it) {
      const int i = tid + it * NT;
      const int r = i / (W / 8), c = c_lo + (i % (W / 8)) * 8;
      const long long g = row0 + r;
      if (g >= p.m || c >= n) continue;
      uint32_t v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        __nv_bfloat162 b = __floats2bfloat162_rn(X[r * XS + c + 2 * e],
                                                 X[r * XS + c + 2 * e + 1]);
        v[e] = *reinterpret_cast<uint32_t*>(&b);
      }
      *reinterpret_cast<uint4*>(static_cast<bf16*>(p.q) + g * n + c) =
          make_uint4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int i = tid; i < ROWS * W; i += NT) {
      const int r = i / W, c = c_lo + i % W;
      const long long g = row0 + r;
      if (g >= p.m || c >= n) continue;
      if (p.q_bf16)
        static_cast<bf16*>(p.q)[g * n + c] = __float2bfloat16_rn(X[r * XS + c]);
      else
        static_cast<float*>(p.q)[g * n + c] = X[r * XS + c];
    }
  }
}

// ---------------------------------------------------------------------
// The pass.  GCODE: -1 no Gram, 0 fp32, 1 bf16, 2 two parts, 3 three.
// TEAMS = 2 (calls without a Gram whose factors stay resident): the CTA
// runs as two teams of four warps, each with its own ring and parts on
// alternate 32-row halves of the tiles, so that one team's splits, loads
// and stores overlap the other's products; both read the one copy of R.

template <int GCODE, int TEAMS>
__global__ void __launch_bounds__(THREADS, 1) stream_gram_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool GRAM = GCODE >= 0;
  constexpr int TW = 8 / TEAMS, NT = 32 * TW, TR = TM / TEAMS;
  constexpr int TEAM_PARTS = 3 * TR * BS * 2, TEAM_SLOT = TR * XS * 4;
  static_assert(!GRAM || TEAMS == 1, "a Gram runs on one team");
  const int team = threadIdx.x / NT, tid = threadIdx.x % NT;
  const int S = p.slots;
  int r_buf = 0;
  for (int d = 0; d < p.n_dots; ++d) {
    const int end = pick(p.r_off, d) + image_bytes(pick(p.dot_code, d));
    r_buf = end > r_buf ? end : r_buf;
  }
  unsigned char* rbuf = smem;
  unsigned char* mine = smem + r_buf + team * (TEAM_PARTS + S * TEAM_SLOT);
  bf16* parts = reinterpret_cast<bf16*>(mine);
  float* slots = reinterpret_cast<float*>(mine + TEAM_PARTS);
#ifdef STREAM_GRAM_PROFILE
  if (threadIdx.x == 0) {
    for (int k = 0; k < N_PHASES; ++k) phase_cycles[k] = 0;
    phase_mark = clock64();
  }
#endif
  // This CTA's TM-row tiles: a Gram call's pair shares one contiguous
  // range (CTA h of the pair owns P's columns 64 h ..), any other CTA has
  // its own.  The ranges depend on m alone.  Team k takes the k-th TR-row
  // part of each tile.
  long long t0, t1, pair = 0;
  int h = 0;
  if (GRAM) {
    const long long pairs = gridDim.x / 2;
    pair = blockIdx.x / 2;
    h = blockIdx.x & 1;
    t0 = pair * p.tiles / pairs;
    t1 = (pair + 1) * p.tiles / pairs;
  } else {
    t0 = blockIdx.x * p.tiles / gridDim.x;
    t1 = (blockIdx.x + 1) * p.tiles / gridDim.x;
  }
  const long long n_sub = (t1 - t0);  // sub-tiles of this team
  const long long row_base = t0 * TM + team * TR;
  if (p.n_dots && p.r_resident)
    for (int d = 0; d < p.n_dots; ++d)
      copy_image(rbuf + pick(p.r_off, d), p.r_image + (size_t)d * R_IMAGE_MAX,
                 image_bytes(pick(p.dot_code, d)));
  __syncthreads();  // R resident
  for (int s = 0; s < S - 1; ++s) {
    if (s < n_sub)
      issue_tile<TR, NT>(p, row_base + s * TM, slots + s * (TEAM_SLOT / 4),
                         tid);
    cp_commit();
  }
  double* part = GRAM ? p.partials + (size_t)pair * p.n * p.n : nullptr;
  bool first = true;
  float acc[GCODE > 0 ? 3 : 1][2][4][4];  // bf16 Gram buckets
  float s32[GCODE == 0 ? 4 : 1][8];       // fp32 Gram sums
  if constexpr (GCODE > 0) {
#pragma unroll
    for (int s = 0; s < 3; ++s)
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[s][i][j][e] = 0.f;
  }
  if constexpr (GCODE == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s32[i][j] = 0.f;
  }
  PHASE(9);

  for (long long i = 0; i < n_sub; ++i) {
    const long long tile = t0 + i, row0 = row_base + i * TM;
    float* X = slots + (i % S) * (TEAM_SLOT / 4);
    if (i + S - 1 < n_sub)
      issue_tile<TR, NT>(p, row0 + (S - 1) * TM,
                         slots + ((i + S - 1) % S) * (TEAM_SLOT / 4), tid);
    cp_commit();
    cp_wait_ring(S);
    team_sync<TEAMS>(team);  // the tile is in its slot
    PHASE(0);
    if (p.alias_sync) cluster_arrive();  // this CTA has read the tile
    PHASE(1);
    for (int d = 0; d < p.n_dots; ++d) {
      const unsigned char* R = rbuf + pick(p.r_off, d);
      if (!p.r_resident) {  // chained factors: the image from L2
        copy_image(rbuf, p.r_image + (size_t)d * R_IMAGE_MAX,
                   image_bytes(pick(p.dot_code, d)));
        PHASE(2);
      }
      run_dot<GRAM ? 1 : 2, TEAMS>(p, d, R, parts, X, team);
    }
    if constexpr (GCODE > 0) {
      split_x<true, TM, THREADS>(X, parts, GCODE, h, threadIdx.x);
      __syncthreads();  // Gram parts complete
      PHASE(5);
    }
    if (p.write_q) {
      if (p.alias_sync) cluster_wait();  // the partner has read it too
      write_q<GRAM, TR, NT>(p, X, row0, h, tid);
      PHASE(6);
    }
    if constexpr (GCODE == 0) gram_fp32(X, h, s32);
    if constexpr (GCODE > 0) gram_mma<GCODE>(parts, h, acc);
    PHASE(7);
    if (GRAM && ((tile + 1 - t0) % TPC == 0 || tile + 1 == t1)) {
      if constexpr (GCODE == 0) fold_fp32(part, p.n, h, first, s32);
      if constexpr (GCODE > 0) fold_mma<GCODE>(part, p.n, h, first, acc);
      first = false;
      PHASE(8);
    }
    team_sync<TEAMS>(team);  // the slot and the parts are free
    PHASE(9);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#ifdef STREAM_GRAM_PROFILE
  if (threadIdx.x == 0 && blockIdx.x < MAX_PROFILED_CTAS)
    for (int k = 0; k < N_PHASES; ++k)
      g_phase_cycles[blockIdx.x * N_PHASES + k] = phase_cycles[k];
#endif
}

// ---------------------------------------------------------------------
// The reduction stage: out[e] = sum over partials b of partials[b][e] in
// float64, in a fixed order.  A CTA owns RED_E entries; its thread
// (group g, entry e) sums the partials g, g + RED_G, ... in order, and
// then one thread per entry adds the RED_G group sums in order.
#define RED_E 32
#define RED_G 8
__global__ void __launch_bounds__(RED_E * RED_G)
    stream_gram_reduce_kernel(const double* partials, float* out, int slabs,
                              int nn) {
  __shared__ double group[RED_G][RED_E];
  const int el = threadIdx.x % RED_E, gi = threadIdx.x / RED_E;
  const int e = blockIdx.x * RED_E + el;
  double s = 0.0;
  if (e < nn) {
#pragma unroll 4
    for (int b = gi; b < slabs; b += RED_G) s += partials[(size_t)b * nn + e];
  }
  group[gi][el] = s;
  __syncthreads();
  if (gi == 0 && e < nn) {
    double t = group[0][el];
#pragma unroll
    for (int j = 1; j < RED_G; ++j) t += group[j][el];
    out[e] = (float)t;
  }
}

// ---------------------------------------------------------------------
// Host side.

typedef void (*KernelFn)(Params);

static KernelFn kernel_for(int gram_code, int teams) {
  switch (gram_code) {
    case 0: return stream_gram_kernel<0, 1>;
    case 1: return stream_gram_kernel<1, 1>;
    case 2: return stream_gram_kernel<2, 1>;
    case 3: return stream_gram_kernel<3, 1>;
    default:
      return teams == 2 ? stream_gram_kernel<-1, 2> : stream_gram_kernel<-1, 1>;
  }
}

// Shared memory of a launch: the R images (all resident if they fit with
// two slots a team, else one image's room, refilled per dot), then each
// team's parts and 2-4 slots.  A call without a Gram whose images stay
// resident runs as two teams.  Returns the bytes, or 0 if nothing fits.
static int plan_smem(int n_dots, const int codes[3], int gram_code,
                     int* resident, int r_off[3], int* slots, int* teams) {
  int all = 0, most = 0;
  for (int d = 0; d < n_dots; ++d) {
    r_off[d] = all;
    all += image_bytes(codes[d]);
    most = image_bytes(codes[d]) > most ? image_bytes(codes[d]) : most;
  }
  for (int d = n_dots; d < 3; ++d) r_off[d] = 0;
  *resident = all + PARTS_BYTES + 2 * SLOT_BYTES <= SMEM_MAX;
  if (!*resident)
    for (int d = 0; d < 3; ++d) r_off[d] = 0;
  *teams = gram_code < 0 && *resident ? 2 : 1;
  const int r = *resident ? all : most;
  const int team_parts = PARTS_BYTES / *teams, team_slot = SLOT_BYTES / *teams;
  int s = ((SMEM_MAX - r) / *teams - team_parts) / team_slot;
  s = s > MAX_SLOTS ? MAX_SLOTS : s;
  if (s < 2) return 0;
  *slots = s;
  return r + *teams * (team_parts + s * team_slot);
}

static cudaLaunchConfig_t launch_config(int grid, int smem,
                                        cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 2;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

extern "C" {

int stream_gram_tile_rows(void) { return TM; }
int stream_gram_chunk_rows(void) { return CHUNK; }
int stream_gram_n_max(void) { return NP; }
int stream_gram_r_image_bytes(void) { return R_IMAGE_MAX; }

#ifdef STREAM_GRAM_PROFILE
// Copy the last launch's phase cycles, (MAX_PROFILED_CTAS, N_PHASES)
// int64, to the host.
int stream_gram_phase_cycles(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_phase_cycles,
                                   sizeof(long long) * MAX_PROFILED_CTAS *
                                       N_PHASES);
}
#endif

// CTAs for a launch, always even (clusters of 2), no more than fit on the
// card at once and no more than one pair (Gram) or CTA (otherwise) per
// tile.  A Gram call's float64 partials: one (n, n) slab a pair.
int stream_gram_grid(long long m, int n, int n_dots, int code0, int code1,
                     int code2, int gram_code, int* grid) {
  if (n < 1 || n > NP || m < 1 || n_dots < 0 || n_dots > 3 ||
      gram_code > 3)
    return (int)cudaErrorInvalidValue;
  const int codes[3] = {code0, code1, code2};
  int resident, r_off[3], slots, teams;
  const int smem =
      plan_smem(n_dots, codes, gram_code, &resident, r_off, &slots, &teams);
  if (!smem) return (int)cudaErrorInvalidConfiguration;
  KernelFn k = kernel_for(gram_code, teams);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(2, smem, 0, &attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, k, &cfg);
  if (err != cudaSuccess) return (int)err;
  if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (m + TM - 1) / TM;
  if (gram_code >= 0) {
    *grid = 2 * (int)(tiles < clusters ? tiles : clusters);
  } else {
    const long long g = tiles < 2LL * clusters ? tiles : 2LL * clusters;
    *grid = (int)((g + 1) / 2 * 2);
  }
  return 0;
}

int stream_gram_launch(const void* a, int a_bf16, const float* r0,
                       const float* r1, const float* r2, int n_dots,
                       int code0, int code1, int code2, int res0, int res1,
                       int res2, void* r_image, void* q, int q_bf16,
                       int write_q, int alias_q, int gram_code,
                       double* partials, long long m, int n, int grid,
                       void* stream) {
  const int codes[3] = {code0, code1, code2};
  for (int d = 0; d < n_dots; ++d)
    if (codes[d] < 0 || codes[d] > 3) return (int)cudaErrorInvalidValue;
  if (n < 1 || n > NP || n_dots < 0 || n_dots > 3 || grid < 2 ||
      grid % 2 || gram_code > 3 || (!write_q && gram_code < 0) ||
      (n_dots && !r_image))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  Params p;
  p.a = a;
  p.r_image = static_cast<const unsigned char*>(r_image);
  p.q = q;
  p.partials = partials;
  p.m = m;
  p.tiles = (m + TM - 1) / TM;
  p.n = n;
  p.a_bf16 = a_bf16;
  p.q_bf16 = q_bf16;
  p.write_q = write_q;
  p.n_dots = n_dots;
  const int esize = a_bf16 ? 2 : 4, qsize = q_bf16 ? 2 : 4;
  p.a_fast = (n * esize) % 16 == 0 && (uintptr_t)a % 16 == 0;
  p.q_fast = write_q && (n * qsize) % 16 == 0 && (uintptr_t)q % 16 == 0;
  p.alias_sync = alias_q && gram_code >= 0;
  for (int d = 0; d < 3; ++d) {
    p.dot_code[d] = codes[d];
    p.residual[d] = d == 0 ? res0 : (d == 1 ? res1 : res2);
  }
  int teams;
  const int smem = plan_smem(n_dots, codes, gram_code, &p.r_resident,
                             p.r_off, &p.slots, &teams);
  if (!smem) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err;
  if (n_dots) {
    SplitParams sp;
    sp.r[0] = r0;
    sp.r[1] = r1;
    sp.r[2] = r2;
    sp.image = static_cast<unsigned char*>(r_image);
    for (int d = 0; d < 3; ++d) sp.code[d] = codes[d];
    sp.n_dots = n_dots;
    sp.n = n;
    const int total = n_dots * NP * NP;
    stream_gram_split_r_kernel<<<(total + 255) / 256, 256, 0, st>>>(sp);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  KernelFn k = kernel_for(gram_code, teams);
  err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = launch_config(grid, smem, st, &attr);
  err = cudaLaunchKernelEx(&cfg, k, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int stream_gram_reduce(const double* partials, float* out, int slabs, int nn,
                       void* stream) {
  stream_gram_reduce_kernel<<<(nn + RED_E - 1) / RED_E, RED_E * RED_G, 0,
                              (cudaStream_t)stream>>>(partials, out, slabs,
                                                      nn);
  return (int)cudaGetLastError();
}

}  // extern "C"
