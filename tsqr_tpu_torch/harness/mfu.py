"""MFU of the CholeskyQR pipelines on the card: useful flops against the
flops the pipeline runs, and the implied memory rate.

Counterpart of ``tsqr_tpu/harness/mfu.py``, with the same CSV header (so
the plotters of ``scripts/`` read it) and the H100's peaks in place of
the TPU's:

* useful_tflops / useful_mfu: ``qr_flops(m, n)`` over the median device
  time, against the bf16 tensor-core peak (989 TFLOP/s): what a user's
  workload gets.
* method_tflops / method_mfu: the products the pipeline runs
  (``flops.fused_products`` / ``xla_products``, 2 m n^2 flops each);
  method_mfu = (bf16 product flops / 989e12 + float32 product flops /
  67e12) / t, the share of the time the card's units need for them (the
  reference's definition where every product is bf16).
* hbm_gbps: the modelled m-scale traffic over the time; above 1.02 x the
  data sheet's 3.35 TB/s the row is flagged ``bw_exceeds_spec`` (the
  model or the timing is wrong for it).

    python -m tsqr_tpu_torch.harness.main mfu [--quick]
"""

from __future__ import annotations

import statistics
import sys
from typing import IO, Sequence

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import cholqr
from tsqr_tpu_torch.harness import flops as flops_mod
from tsqr_tpu_torch.utils import status, timing, validation

CSV_HEADER = ("m,n,compute_mode,method,variant,elapsed_time,orthogonality,"
              "useful_tflops,useful_mfu,method_tflops,method_mfu,hbm_gbps,"
              "flag")

CONFIGS = (
    ("bf16", "cholqr1_fused", "safe"),
    ("bf16", "cholqr2_fused", "safe"),
    ("bf16_nocor", "cholqr2_fused", "safe"),
    ("bf16x3_cor", "cholqr2_fused", "safe"),
    ("bf16x6_cor", "cholqr2_fused", "safe"),
    ("bf16x6_cor", "cholqr2_fused", "fast"),
    ("bf16x6_cor", "cholqr2_fused", "fastest"),
    ("bf16x6_cor", "cholqr2_fused", "turbo"),
    ("bf16x6_cor", "cholqr1_fused", "safe"),
    ("bf16x6_cor", "cholqr3_fused", "safe"),
    ("bf16x6_cor", "cholqr3_fused", "compact"),
)


class OffFusedRange(ValueError):
    """A fused method asked for past the stream kernel's range: it would
    run its non-fused sibling, which the fused models do not describe."""


def mfu_row(m: int, n: int, mode: str, method: str, variant: str = "safe",
            seed: int = 0, reps: int = 3) -> dict:
    """One row: ``fastqr(a, mode, method, variant)`` on a uniform[-1, 1]
    (m, n) input on the card (in the mode's IO type), timed by CUDA
    events (median of ``reps`` after one warm-up)."""
    fused = method.endswith("_fused")
    if fused and n > cholqr._fused_n_max(modes.resolve(mode)):
        raise OffFusedRange(f"{method} runs its non-fused sibling at n={n}; "
                            "no fused MFU row")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = (torch.rand(m, n, device="cuda", generator=gen) * 2 - 1).to(
        modes.resolve(mode).io_dtype)

    def fn():
        return cholqr.fastqr(a, mode, method=method, variant=variant)

    q, _ = fn()
    orth = validation.orthogonality_accurate(q)
    del q
    t = statistics.median(timing.time_cuda(fn, reps=reps, warmup=1)) / 1e3
    if fused:
        prods = flops_mod.fused_products(mode, method, variant)
        hbm = flops_mod.fused_hbm_bytes(m, n, mode, method, variant)
    else:
        prods = flops_mod.xla_products(mode, method)
        hbm = flops_mod.xla_hbm_bytes(m, n, mode, method)
    unit = 2.0 * m * n * n
    bf16_fl, fp32_fl = prods["bf16"] * unit, prods["fp32"] * unit
    useful = flops_mod.qr_flops(m, n)
    hbm_gbps = hbm / t / 1e9
    flag = ("bw_exceeds_spec"
            if hbm_gbps > 1.02 * flops_mod.H100_BYTES_PER_S / 1e9 else "")
    return {"m": m, "n": n, "compute_mode": mode, "method": method,
            "variant": variant, "elapsed_time": t, "orthogonality": orth,
            "useful_tflops": useful / t / 1e12,
            "useful_mfu": useful / t / flops_mod.H100_BF16_FLOPS,
            "method_tflops": (bf16_fl + fp32_fl) / t / 1e12,
            "method_mfu": (bf16_fl / flops_mod.H100_BF16_FLOPS
                           + fp32_fl / flops_mod.H100_FP32_FLOPS) / t,
            "hbm_gbps": hbm_gbps, "flag": flag}


def format_row(r: dict) -> str:
    return (f"{r['m']},{r['n']},{r['compute_mode']},{r['method']},"
            f"{r['variant']},{r['elapsed_time']:.6e},"
            f"{r['orthogonality']:.3e},{r['useful_tflops']:.3f},"
            f"{r['useful_mfu']:.4f},{r['method_tflops']:.3f},"
            f"{r['method_mfu']:.4f},{r['hbm_gbps']:.1f},{r['flag']}")


def sweep(m: int = 1 << 20,
          ns: Sequence[int] = (128, 256, 512, 1024, 2048),
          configs: Sequence[tuple[str, str, str]] = CONFIGS,
          out: IO = sys.stdout) -> tuple[list[dict], list[str]]:
    """Every config at every n, m_eff = min(m, 2^28 / n) rows.  Past the
    kernel's range a fused config's row is its non-fused sibling's, once
    (its "safe" variant; the other variants share it).  A config that
    fails prints a '# error' line and the sweep goes on.  Returns (rows,
    errors)."""
    print(CSV_HEADER, file=out, flush=True)
    rows, errors = [], []
    for mode, method, variant in configs:
        for n in ns:
            m_eff = min(m, (1 << 28) // n)
            try:
                try:
                    row = mfu_row(m_eff, n, mode, method, variant)
                except OffFusedRange:
                    if variant != "safe":
                        continue
                    row = mfu_row(m_eff, n, mode,
                                  method.removesuffix("_fused"), "safe")
            except Exception as e:  # noqa: BLE001 (the sweep goes on)
                note = (f"# error n={n} {mode}/{method}/{variant}: "
                        f"{status.exc_note(e)}")
                errors.append(note)
                print(note, file=out, flush=True)
                continue
            rows.append(row)
            print(format_row(row), file=out, flush=True)
    return rows, errors
