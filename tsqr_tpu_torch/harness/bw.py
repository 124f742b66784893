"""Memory-bandwidth probes on the card: what a pure read and a read +
write of A reach, beside the stream kernel's passes over the same A.

Counterpart of ``scripts/bw_experiments.py``.  It runs the two probes of
``ops/bw_probe.py`` at (2^22, 128) float32 ((2^21, 128) with ``--quick``)
over a sweep of rows per CTA (the reference's ``chunk``), ``torch.mul``
by the copy's scale (the library call of the same copy), then the
stream kernel once per Gram mode (bf16x6_cor, fp32, and bf16 on a bf16
A) and once as a bf16x6_cor Q pass, and prints the CSV
``probe,elapsed_time,gbps,loops`` to stdout: elapsed_time is the median
seconds per call over ``loops`` CUDA-event timings after one warm-up,
gbps the bytes the call must move (each input read once, each output
written once) over that time.  It writes no file.

    python -m tsqr_tpu_torch.harness.bw [--quick]
"""

from __future__ import annotations

import argparse
import statistics
import sys
from typing import IO

import torch

from tsqr_tpu_torch.ops import bw_probe, gram_stream
from tsqr_tpu_torch.utils import status, timing

CSV_HEADER = "probe,elapsed_time,gbps,loops"
READ_ROWS_PER_CTA = (2048, 4096, 8192, 16384)
COPY_ROWS_PER_CTA = (8, 16, 2048, 4096)
LOOPS = 10


def _row(name: str, nbytes: int, fn, out: IO, loops: int) -> dict:
    t = statistics.median(timing.time_cuda(fn, reps=loops, warmup=1)) / 1e3
    row = {"probe": name, "elapsed_time": t, "gbps": nbytes / t / 1e9,
           "loops": loops}
    print(f"{name},{t:.6e},{row['gbps']:.1f},{loops}", file=out, flush=True)
    return row


def sweep(m: int = 1 << 22, n: int = 128, seed: int = 0,
          out: IO = sys.stdout, loops: int = LOOPS) -> list[dict]:
    """The probes and the stream passes at (m, n); returns the rows."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a32 = torch.rand(m, n, device="cuda", generator=gen) * 2 - 1
    nbytes = m * n * 4
    print(CSV_HEADER, file=out, flush=True)
    rows = []
    for rpc in READ_ROWS_PER_CTA:
        rows.append(_row(f"read_reduce_rows_per_cta={rpc}", nbytes,
                         lambda rpc=rpc: bw_probe.read_reduce(a32, rpc),
                         out, loops))
    for rpc in COPY_ROWS_PER_CTA:
        rows.append(_row(f"copy_rows_per_cta={rpc}", 2 * nbytes,
                         lambda rpc=rpc: bw_probe.copy(a32, rpc), out, loops))
    rows.append(_row("library_torch.mul", 2 * nbytes,
                     lambda: torch.mul(a32, bw_probe.COPY_SCALE), out, loops))
    for mode in ("bf16x6_cor", "fp32"):
        rows.append(_row(f"gram_{mode}", nbytes,
                         lambda mode=mode: gram_stream.gram_stream(a32, mode),
                         out, loops))
    a16 = a32.bfloat16()
    rows.append(_row("gram_bf16(bf16_in)", nbytes // 2,
                     lambda: gram_stream.gram_stream(a16, "bf16"), out, loops))
    del a16
    rinv = torch.eye(n, device="cuda") * 1.001
    rows.append(_row("qpass_bf16x6_cor", 2 * nbytes,
                     lambda: gram_stream.qpass_stream(a32, rinv, "bf16x6_cor",
                                                      with_gram=False),
                     out, loops))
    return rows


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--quick", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("harness.bw measures on a CUDA card; none found")
    status.print_banner(file=sys.stderr)
    sweep(m=(1 << 21) if args.quick else (1 << 22))


if __name__ == "__main__":
    main()
