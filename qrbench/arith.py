"""The benchmark's frozen arithmetic: useful flops, the least time an
H100 SXM could take for a stream pass or a panel-kernel launch, and the
union of time intervals.

A copy of the sound parts of ``tsqr_tpu_torch/harness/flops.py``
(``qr_flops``, ``stream_bound`` without the design's extra traffic,
``panel_bound``) and of ``harness/profile.py``'s ``_union_us``, kept here
so that no change to the program can move the yardstick.  A bound counts
what a call must read, write and compute: each input byte read once,
each output byte written once, the products at the mode's count of
split products.  Modes are the program's mode strings.
"""

from __future__ import annotations

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
ITEM_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


def qr_flops(m: int, n: int) -> float:
    """Householder thin-QR flops (R and the thin Q), the standard count:
    the useful work of one QR of an (m, n) matrix, whatever computes it."""
    return 2.0 * m * n * n - (2.0 / 3.0) * n ** 3 + 2.0 * m * n * n


def bound(nbytes: float, bf16_flops: float, fp32_flops: float) -> dict:
    """The least time for ``nbytes`` of device memory traffic and the
    given products: the larger of bytes over bandwidth and operations
    over peak."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = bf16_flops / H100_BF16_FLOPS + fp32_flops / H100_FP32_FLOPS
    return {"bytes": nbytes, "bf16_flops": bf16_flops,
            "fp32_flops": fp32_flops, "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def stream_bound(m: int, n: int, dot_modes=(), gram_mode: str | None = None,
                 write_q: bool = False, in_bytes: int = 4,
                 out_bytes: int = 4) -> dict:
    """One stream pass over an (m, n) A: A read once, each (n, n) factor
    read once, Q written once (``write_q``), the (n, n) half-Gram written
    once; the chained dots at ``DOT_PRODUCTS`` and the half-Gram at
    ``GRAM_PRODUCTS`` split products of 2 m n^2 flops each."""
    nbytes = (m * n * in_bytes + len(dot_modes) * n * n * 4
              + (m * n * out_bytes if write_q else 0)
              + (n * n * 4 if gram_mode is not None else 0))
    unit = 2.0 * m * n * n
    counts = [(md, DOT_PRODUCTS[md]) for md in dot_modes]
    if gram_mode is not None:
        counts.append((gram_mode, GRAM_PRODUCTS[gram_mode]))
    fp32 = sum(unit * k for md, k in counts if md == "fp32")
    bf16 = sum(unit * k for md, k in counts if md != "fp32")
    return bound(nbytes, bf16, fp32)


def panel_bound(batch: int, L: int, n: int, mode: str) -> dict:
    """One panel-kernel launch on (batch, L, n) float32 tiles: A read
    once, Q^T (batch, n, L) and R (batch, n, n) written once; a tile's
    Householder factorization and thin-Q build, 4 L n^2 - 4 n^3 / 3 flops,
    at the mode's split products as a dot counts them."""
    nbytes = 4 * batch * (2 * L * n + n * n)
    flops = (batch * (4.0 * L * n * n - (4.0 / 3.0) * n ** 3)
             * DOT_PRODUCTS[mode])
    return bound(nbytes, 0.0 if mode == "fp32" else flops,
                 flops if mode == "fp32" else 0.0)


def union_length(intervals) -> float:
    """Length of the union of [start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(intervals):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total
