// Native mixed-precision GEMM emulation cores.
//
// TPU-native rebuild of the reference's Tensor-Core emulator
// (src/matmul.hpp:26-209): computes matrix products with operand mantissas
// clipped to a given width (bf16=7 bits, tf32=10 bits) and with the
// split-correction scheme (hi*hi + hi*lo + lo*hi), entirely on the host
// CPU in C++.  Used as an independent golden for the precision policies
// (tsqr_tpu_torch/modes.py): two implementations of the same arithmetic
// in two languages/compilers must agree, which pins down the semantics of
// the clipping and correction steps.
//
// Exposed via a C ABI for ctypes (no pybind11 in this environment).

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

// Round a float to `bits` explicit mantissa bits, round-to-nearest-even.
// ≙ cutf::experimental::cut_mantissa as used in matmul.hpp:86-108.
inline float clip_mantissa(float x, int bits) {
  if (!std::isfinite(x) || x == 0.0f) return x;
  uint32_t u;
  std::memcpy(&u, &x, 4);
  const int drop = 23 - bits;
  if (drop <= 0) return x;
  const uint32_t half = 1u << (drop - 1);
  const uint32_t lsb = (u >> drop) & 1u;
  u = (u + half - 1u + lsb) & (0xFFFFFFFFu << drop);
  float out;
  std::memcpy(&out, &u, 4);
  return out;
}

// C = A(mxk) * B(kxn), operands clipped per-element, fp32 accumulation.
void gemm_clipped(const float* a, const float* b, float* c, int m, int n,
                  int k, int bits) {
  for (int i = 0; i < m; ++i) {
    for (int j = 0; j < n; ++j) {
      float acc = 0.0f;
      for (int p = 0; p < k; ++p) {
        acc += clip_mantissa(a[i * k + p], bits) *
               clip_mantissa(b[p * n + j], bits);
      }
      c[i * n + j] = acc;
    }
  }
}

}  // namespace

extern "C" {

// ≙ tf32_tc_nocor_emu (matmul.hpp:86-108) generalized over mantissa width.
void emu_gemm_nocor(const float* a, const float* b, float* c, int m, int n,
                    int k, int bits) {
  gemm_clipped(a, b, c, m, n, k, bits);
}

// Split-corrected: hi*hi + hi*lo + lo*hi with hi/lo both clipped
// (≙ tf32_tc_cor_emu, matmul.hpp:26-54: a*db + da*b correction terms).
void emu_gemm_cor(const float* a, const float* b, float* c, int m, int n,
                  int k, int bits) {
  for (int i = 0; i < m; ++i) {
    for (int j = 0; j < n; ++j) {
      float hh = 0.0f, hl = 0.0f, lh = 0.0f;
      for (int p = 0; p < k; ++p) {
        const float av = a[i * k + p], bv = b[p * n + j];
        const float ah = clip_mantissa(av, bits);
        const float al = clip_mantissa(av - ah, bits);
        const float bh = clip_mantissa(bv, bits);
        const float bl = clip_mantissa(bv - bh, bits);
        hh += ah * bh;
        hl += ah * bl;
        lh += al * bh;
      }
      c[i * n + j] = hh + (hl + lh);
    }
  }
}

// Mixed: clipped main product + full-precision residual terms
// (≙ mixed_tc_cor_emu, matmul.hpp:56-84).
void emu_gemm_mixed(const float* a, const float* b, float* c, int m, int n,
                    int k, int bits) {
  for (int i = 0; i < m; ++i) {
    for (int j = 0; j < n; ++j) {
      float hh = 0.0f, hl = 0.0f, lh = 0.0f;
      for (int p = 0; p < k; ++p) {
        const float av = a[i * k + p], bv = b[p * n + j];
        const float ah = clip_mantissa(av, bits);
        const float al = av - ah;
        const float bh = clip_mantissa(bv, bits);
        const float bl = bv - bh;
        hh += ah * bh;
        hl += ah * bl;
        lh += al * bh;
      }
      c[i * n + j] = hh + (hl + lh);
    }
  }
}

// Scalar hook so tests can pin the clipping semantics bit-exactly.
float emu_clip_mantissa(float x, int bits) { return clip_mantissa(x, bits); }

}  // extern "C"
