// The bf16 splits of the compute modes, shared by the package's kernels so
// that each rounds a float32 operand the same way.
//
// Mode codes: 0 fp32 (one unrounded part), 1 bf16 (one bf16 part), 2 two
// bf16 parts (bf16x3_*), 3 three bf16 parts (bf16x6_cor).  v ≈ p0 + p1 +
// p2, each part bf16-exact and held in float32, as modes.split2/split3
// compute it.  A product of two parts is exact in float32; a mode keeps
// the products of combined residual order up to parts - 1, sums each
// order on its own and adds the orders smallest first (sum_orders).

#pragma once

#include <cuda_bf16.h>

__device__ __forceinline__ int n_parts(int code) { return code <= 1 ? 1 : code; }

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The parts of v for a mode code, into p[0 .. n_parts(code)).
__device__ __forceinline__ void split_parts(float v, int code, float p[3]) {
  if (code == 0) {
    p[0] = v;
    return;
  }
  p[0] = bf16_round(v);
  if (code >= 2) {
    const float r = __fsub_rn(v, p[0]);
    p[1] = bf16_round(r);
    if (code == 3) p[2] = bf16_round(__fsub_rn(r, p[1]));
  }
}

// Split v into its parts, stored stride apart (split_parts' arithmetic,
// each part stored as soon as it is formed).
__device__ __forceinline__ void split_store(float v, int code, float* dst,
                                            int stride) {
  if (code == 0) {
    dst[0] = v;
    return;
  }
  float p0 = bf16_round(v);
  dst[0] = p0;
  if (code >= 2) {
    float r = __fsub_rn(v, p0);
    float p1 = bf16_round(r);
    dst[stride] = p1;
    if (code == 3) dst[2 * stride] = bf16_round(__fsub_rn(r, p1));
  }
}

// Bucket sums b_0 + b_1 + b_2 of a product, smallest order first.
__device__ __forceinline__ float sum_orders(float b0, float b1, float b2,
                                            int order) {
  float y = order == 2 ? b2 : (order == 1 ? b1 : b0);
  if (order >= 2) y = __fadd_rn(y, b1);
  if (order >= 1) y = __fadd_rn(y, b0);
  return y;
}

// acc[s] += x_u y_w over the parts with u + w = s <= parts - 1: the
// product terms of one element pair that a mode keeps.
template <int CODE>
__device__ __forceinline__ void fma_parts(const float x[3], const float y[3],
                                          float acc[3]) {
  acc[0] = fmaf(x[0], y[0], acc[0]);
  if (CODE >= 2) {
    acc[1] = fmaf(x[0], y[1], acc[1]);
    acc[1] = fmaf(x[1], y[0], acc[1]);
  }
  if (CODE == 3) {
    acc[2] = fmaf(x[0], y[2], acc[2]);
    acc[2] = fmaf(x[1], y[1], acc[2]);
    acc[2] = fmaf(x[2], y[0], acc[2]);
  }
}
