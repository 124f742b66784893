"""Flop and byte counts, and the H100's lower bound for a kernel call.

``qr_flops`` is the useful flop count of a thin QR (the JAX package's
count), against which the ladder's TFLOP/s are reported.
``stream_bound`` and ``panel_bound`` count what one ``stream`` call or
one panel-kernel launch must move and compute and turn it into the
least time an H100 SXM could take for it.
"""

from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
H100_BYTES_PER_S = 3.35e12
H100_BF16_FLOPS = 989e12    # tensor cores
H100_FP32_FLOPS = 67e12     # CUDA cores (TF32 is not float32)

# split products per dot / per half-Gram (2 m n^2 flops each); the fp32
# mode's one product is float32, every other mode's are bf16 x bf16
DOT_PRODUCTS = {"fp32": 1, "bf16": 1, "bf16_nocor": 1, "bf16x3_nocor": 3,
                "bf16x3_cor": 3, "bf16x6_cor": 6}
GRAM_PRODUCTS = {"fp32": 1, "bf16": 1, "bf16_nocor": 1, "bf16x3_nocor": 2,
                 "bf16x3_cor": 2, "bf16x6_cor": 4}


def qr_flops(m: int, n: int) -> float:
    """Householder thin-QR flops (R + thin-Q build), standard count."""
    return 2.0 * m * n * n - (2.0 / 3.0) * n ** 3 + 2.0 * m * n * n


def stream_bound(m: int, n: int, dot_modes=(), gram_mode: str | None = None,
                 write_q: bool = False, in_dtype=torch.float32,
                 out_dtype=torch.float32) -> dict:
    """Bytes, split-product flops and the H100 lower bound of one stream
    pass: A read once, each rinv read once, Q written once, P written
    once.  Returns {"bytes", "bf16_flops", "fp32_flops", "bound_ms",
    "bound_by"}."""
    isz = torch.empty((), dtype=in_dtype).element_size()
    osz = torch.empty((), dtype=out_dtype).element_size()
    nbytes = (m * n * isz + len(dot_modes) * n * n * 4
              + (m * n * osz if write_q else 0)
              + (n * n * 4 if gram_mode is not None else 0))
    unit = 2.0 * m * n * n
    counts = [(md, DOT_PRODUCTS[md]) for md in dot_modes]
    if gram_mode is not None:
        counts.append((gram_mode, GRAM_PRODUCTS[gram_mode]))
    fp32 = sum(unit * k for md, k in counts if md == "fp32")
    bf16 = sum(unit * k for md, k in counts if md != "fp32")
    return _bound(nbytes, bf16, fp32)


def panel_bound(batch: int, L: int, n: int, mode: str) -> dict:
    """Bytes, flops and the H100 lower bound of one panel-kernel launch
    on (batch, L, n) float32 tiles: A read once, Q^T (batch, n, L) and R
    (batch, n, n) written once; 4 L n^2 - 4 n^3 / 3 flops a tile (the
    Householder factorization, 2 L n^2 - 2 n^3 / 3, and the thin-Q build,
    the same again; the kernel skips the triangle above each block, so
    the TPU kernel's 4 L n^2 estimate overcounts), counted at the mode's
    split products as ``stream_bound`` counts a dot.  Same keys as
    ``stream_bound``."""
    nbytes = 4 * batch * (2 * L * n + n * n)
    flops = (batch * (4.0 * L * n * n - (4.0 / 3.0) * n ** 3)
             * DOT_PRODUCTS[mode])
    return _bound(nbytes, 0.0 if mode == "fp32" else flops,
                  flops if mode == "fp32" else 0.0)


def _bound(nbytes: float, bf16: float, fp32: float) -> dict:
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = bf16 / H100_BF16_FLOPS + fp32 / H100_FP32_FLOPS
    return {"bytes": nbytes, "bf16_flops": bf16, "fp32_flops": fp32,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
