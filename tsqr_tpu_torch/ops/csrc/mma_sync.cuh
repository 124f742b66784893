// The mma.sync kernels' device helpers: cp.async copies into shared
// memory, ldmatrix fragments, the bf16 m16n8k16 product and split4, the
// four-value form of splits.cuh's split_parts.  split_mm.cu includes it;
// stream_gram.cu, stream_wide.cu, panel_qr.cu and panel_wide.cu still
// carry copies of their own.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

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
