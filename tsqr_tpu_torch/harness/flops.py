"""Flop and byte counts, and the H100's lower bound for a kernel call.

``qr_flops`` is the useful flop count of a thin QR (the JAX package's
count), against which the ladder's TFLOP/s are reported; ``tsqr_flops``
and ``blockqr_flops`` are the reference's models of the tree and of
BlockQR, for the speed harness.  ``stream_bound`` and ``panel_bound``
count what one ``stream`` call or one panel-kernel launch must move and
compute and turn it into the least time an H100 SXM could take for it.

``fused_products``/``xla_products`` and ``fused_hbm_bytes``/
``xla_hbm_bytes`` model the CholeskyQR pipelines for the MFU harness:
the fused methods (the stream kernel) and the non-fused ones (the
reference's XLA paths, plain PyTorch products here).  The byte models
are the reference's.  The product models have the reference's pipeline
structure but count the port's products, by kind: the reference counts
MXU passes, with float32 as its 6-pass HIGHEST decomposition and a
3-pass bf16x3_nocor half-Gram; the port's fp32 mode is one float32
product on the CUDA cores, its bf16x3_nocor half-Gram is two bf16
products, and its non-fused methods run every product as a float32
matmul of bf16-exact parts on the CUDA cores.
"""

from __future__ import annotations

import torch

from tsqr_tpu_torch.core import tsqr as tsqr_mod

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


def default_leaf_rows(n: int) -> int:
    """The tree's default leaf height at width n (``core.tsqr.tsqr`` with
    ``leaf_rows=None``): the panel kernel's largest tile for n <= 128,
    the blocked Householder's ``DEFAULT_LEAF_ROWS`` past it."""
    return tsqr_mod.default_leaf_rows(n)


def tsqr_flops(m: int, n: int, leaf_rows: int | None = None,
               fanin: int = tsqr_mod.DEFAULT_FANIN) -> float:
    """Flops of the TSQR tree: the leaf and node QRs and the backward
    products."""
    leaf_rows = leaf_rows or default_leaf_rows(n)
    bs, L, m_pad = tsqr_mod.plan_tree(m, n, leaf_rows, fanin)
    total = bs * qr_flops(L, n)
    b = bs
    while b > 1:
        f = min(fanin, b)
        total += (b // f) * qr_flops(f * n, n)
        total += (b // f) * 2.0 * (f * n) * n * n
        b //= f
    return total + 2.0 * m_pad * n * n


def blockqr_flops(m: int, n: int, panel_width: int,
                  leaf_rows: int | None = None,
                  fanin: int = tsqr_mod.DEFAULT_FANIN,
                  reorth: bool = False) -> float:
    """BlockQR = one tree per panel (two with ``reorth`` past the first)
    plus the projection products, the reference's model."""
    nb = min(panel_width, n)
    total = 0.0
    for b in range(-(-n // nb)):
        w = min(nb, n - b * nb)
        k = b * nb
        mult = 2 if reorth and b > 0 else 1
        total += mult * tsqr_flops(m, w, leaf_rows, fanin)
        if b > 0:
            total += 2.0 * 2.0 * m * k * w
            if reorth:
                total += 2.0 * 2.0 * m * k * w
                total += 2.0 * k * w * w + 2.0 * w ** 3
    return total


_CHEAP = ("bf16", "bf16_nocor", "bf16x3_nocor")
_DELTA_MODE = {"bf16x6_cor": "bf16x3_cor", "fp32": "bf16x3_cor"}
_RELAXED_MID = {"bf16x6_cor": "bf16x3_cor", "fp32": "bf16x3_cor",
                "bf16x3_cor": "bf16x3_cor"}


def _tally(terms) -> dict:
    """{"bf16": k, "fp32": k}: products of 2 m n^2 flops by kind, from
    (mode, products) terms."""
    out = {"bf16": 0, "fp32": 0}
    for md, k in terms:
        out["fp32" if md == "fp32" else "bf16"] += k
    return out


def fused_products(mode: str, method: str, variant: str = "safe") -> dict:
    """The products of one fused CholeskyQR call (``core/cholqr.py``'s
    stream passes, standalone: no ``g1``), by kind."""
    def dot(md):
        return md, DOT_PRODUCTS[md]

    def gram(md):
        return md, GRAM_PRODUCTS[md]

    fast_g1 = variant in ("fastest", "turbo")
    g1 = gram("bf16") if fast_g1 else gram(mode)
    last = dot(_DELTA_MODE.get(mode, mode))
    if method == "cholqr1_fused":
        return _tally([gram(mode), dot(mode)])
    if method == "cholqr2_fused":
        if mode in _CHEAP:
            return _tally([g1, dot(mode), gram(mode), dot(mode), dot(mode)])
        if variant in ("compact", "turbo"):
            return _tally([g1, dot(mode), gram(mode), dot(mode), last])
        return _tally([g1, dot(mode), gram(mode),
                       last if variant != "safe" else dot(mode)])
    if method == "cholqr3_fused":
        if mode in _CHEAP:
            return _tally([g1, dot(mode), gram(mode), dot(mode), dot(mode),
                           gram(mode)] + [dot(mode)] * 3)
        if variant == "compact":
            return _tally([gram(mode), dot(_RELAXED_MID.get(mode, mode)),
                           gram(mode), dot(mode), gram(mode), dot(mode),
                           last])
        return _tally([g1, dot(mode), gram(mode), dot(mode), gram(mode),
                       last])
    raise ValueError(method)


def fused_hbm_bytes(m: int, n: int, mode: str, method: str,
                    variant: str = "safe") -> int:
    """Device-memory bytes the fused pipelines move (m-scale traffic
    only), the reference's model."""
    io = 2 if mode == "bf16" else 4
    mn = m * n
    if method == "cholqr1_fused":
        return io * mn * 3
    if method == "cholqr2_fused":
        if mode in _CHEAP or variant in ("compact", "turbo"):
            return io * mn * 4
        return io * mn * 5
    if method == "cholqr3_fused":
        if mode in _CHEAP or variant == "compact":
            return io * mn * 5
        return io * mn * 7
    raise ValueError(method)


def xla_products(mode: str, method: str) -> dict:
    """The products of one non-fused CholeskyQR call (cholqr1 = one Gram
    and one Q pass, cholqr2 twice that, cholqr3 three times), by kind:
    each is ``DOT_PRODUCTS[mode]`` float32 matmuls (``modes.gram`` and
    ``Policy.mm`` split in float32)."""
    steps = {"cholqr1": 2, "cholqr2": 4, "cholqr3": 6}[method]
    return {"bf16": 0, "fp32": steps * DOT_PRODUCTS[mode]}


def xla_hbm_bytes(m: int, n: int, mode: str, method: str) -> int:
    """The least m-scale traffic of the non-fused methods, the
    reference's model: each Gram reads its input once, each Q pass reads
    its input and writes its output (the split parts they materialise
    are not counted, so the implied bandwidth under-states the truth)."""
    io = 2 if mode == "bf16" else 4
    touches = {"cholqr1": 3, "cholqr2": 6, "cholqr3": 9}[method]
    return io * m * n * touches


# bf16 parts a value of x is split into for the wide kernels' products
SPLIT_PARTS = {"fp32": 0, "bf16": 1, "bf16_nocor": 1, "bf16x3_nocor": 2,
               "bf16x3_cor": 2, "bf16x6_cor": 3}


def wide_extra_bytes(m: int, n: int, dot_modes=(),
                     gram_mode: str | None = None, write_q: bool = False,
                     out_dtype=torch.float32, alias_q: bool = False) -> int:
    """Device-memory bytes the wide stream kernels (n > 128,
    ``csrc/stream_wide.cu``) move beyond one read of A and one write of Q:
    each product off fp32 writes x's bf16 parts once and reads them once
    (re-reads from L2 not counted); each product after the first reads
    its x again (an intermediate, or Q for the Gram); each dot before the
    last writes a float32 x, and so does the last where it cannot write Q
    (a store then reads it to Q).  0 for n <= 128."""
    if n <= 128:
        return 0
    x = 4 * m * n
    products = list(dot_modes) + ([gram_mode] if gram_mode else [])
    extra = sum(4 * SPLIT_PARTS[md] * m * n for md in products)
    extra += x * (len(products) - 1)
    if dot_modes:
        extra += x * (len(dot_modes) - 1)
        to_q = (write_q and not (alias_q and len(dot_modes) == 1)
                and (gram_mode is None or out_dtype == torch.float32))
        if not to_q:
            extra += x * (2 if write_q else 1)
    return extra


def stream_bound(m: int, n: int, dot_modes=(), gram_mode: str | None = None,
                 write_q: bool = False, in_dtype=torch.float32,
                 out_dtype=torch.float32, design: bool = False) -> dict:
    """Bytes, split-product flops and the H100 lower bound of one stream
    pass: A read once, each rinv read once, Q written once, P written
    once.  ``design=True`` adds what the wide kernels move beyond that
    (:func:`wide_extra_bytes`).  Returns {"bytes", "bf16_flops",
    "fp32_flops", "bound_ms", "bound_by"}."""
    isz = torch.empty((), dtype=in_dtype).element_size()
    osz = torch.empty((), dtype=out_dtype).element_size()
    nbytes = (m * n * isz + len(dot_modes) * n * n * 4
              + (m * n * osz if write_q else 0)
              + (n * n * 4 if gram_mode is not None else 0))
    if design:
        nbytes += wide_extra_bytes(m, n, dot_modes, gram_mode, write_q,
                                   out_dtype)
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


def probe_bound(m: int, n: int, probe: str) -> dict:
    """Bytes, flops and the H100 lower bound of one bandwidth probe on a
    float32 (m, n) A: "read_reduce" reads A once, writes (8, n) and adds
    once per element; "copy" reads and writes A once and multiplies once
    per element.  Same keys as ``stream_bound``."""
    if probe == "read_reduce":
        return _bound(4 * (m * n + 8 * n), 0.0, float(m * n))
    if probe == "copy":
        return _bound(8 * m * n, 0.0, float(m * n))
    raise ValueError(f"unknown probe {probe!r}")


def _bound(nbytes: float, bf16: float, fp32: float) -> dict:
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = bf16 / H100_BF16_FLOPS + fp32 / H100_FP32_FLOPS
    return {"bytes": nbytes, "bf16_flops": bf16, "fp32_flops": fp32,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
