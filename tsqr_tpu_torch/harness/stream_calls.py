"""Device time of each call kind of the stream kernel, per mode, on the card.

Times ``ops.gram_stream.stream`` at (m, 128) float32 with CUDA events:
the Gram pass and the Q pass at fp32, bf16, bf16x3_cor and bf16x6_cor,
the ``compact_final`` pass (a bf16x6_cor dot, a residual bf16x3_cor dot,
Q and the Gram), the Q pass written over its input (``alias_q``), the
library products ``a.T @ a`` and ``a @ rinv`` and the reduction stage.  Prints one JSON line with the card's name and power
limit:

    python -m tsqr_tpu_torch.harness.stream_calls [--m 1048576] [--reps 7]

Nothing here is compared with a plain version: ``chip_smoke.py`` does that.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import numpy as np
import torch

MODES = ("fp32", "bf16", "bf16x3_cor", "bf16x6_cor")


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def calls(a: torch.Tensor, n: int) -> dict:
    """Call kind -> keyword arguments of ``stream``."""
    gen = torch.Generator(device=a.device).manual_seed(1)
    eye = torch.eye(n, device=a.device)
    rinv = eye + torch.randn(n, n, device=a.device, generator=gen) / (
        4 * math.sqrt(n))
    delta = 1e-3 * torch.randn(n, n, device=a.device,
                               generator=gen) / math.sqrt(n)
    out = {}
    for md in MODES:
        out[f"gram {md}"] = dict(gram_mode=md)
        out[f"qpass {md}"] = dict(rinvs=(rinv,), dot_modes=(md,),
                                  write_q=True)
    out["compact_final bf16x6_cor"] = dict(
        rinvs=(rinv, delta), dot_modes=("bf16x6_cor", "bf16x3_cor"),
        residual=(False, True), write_q=True, gram_mode="bf16x6_cor")
    out["qpass_alias_q bf16x6_cor"] = dict(
        rinvs=(eye,), dot_modes=("bf16x6_cor",), write_q=True, alias_q=True)
    return out


def sweep(m: int, n: int = 128, reps: int = 7) -> dict:
    import tsqr_tpu_torch  # noqa: F401  (TF32 off)
    from tsqr_tpu_torch.ops import gram_stream as gs
    from tsqr_tpu_torch.utils import timing

    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.rand(m, n, device="cuda", generator=gen) * 2 - 1
    a_alias = a.clone()
    out = {}
    for label, cfg in calls(a, n).items():
        src = a_alias if cfg.get("alias_q") else a
        out[label] = float(np.median(timing.time_cuda(
            lambda c=cfg, s=src: gs.stream(s, **c), reps=reps, warmup=2)))
    # the library calls of the same products, float32 (no TF32)
    rinv = calls(a, n)["qpass fp32"]["rinvs"][0]
    out["library a.T@a"] = float(np.median(timing.time_cuda(
        lambda: a.T @ a, reps=reps, warmup=2)))
    out["library a@rinv"] = float(np.median(timing.time_cuda(
        lambda: a @ rinv, reps=reps, warmup=2)))
    # the reduction stage at the Gram pass's partials (one per CTA pair)
    grid = gs.grid_size(m, n, (), gs._kernel_code(gs._mode("bf16x6_cor")))
    part = torch.randn(grid // 2, n, n, dtype=torch.float64, device="cuda",
                       generator=gen)
    out["reduce"] = float(np.median(timing.time_cuda(
        lambda: gs.reduce_partials(part), reps=reps, warmup=2)))
    out["reduce partials.sum(0)"] = float(np.median(timing.time_cuda(
        lambda: part.sum(0), reps=reps, warmup=2)))
    out["reduce_shape"] = list(part.shape)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stream_calls measures on a CUDA device")
    print(json.dumps({"stream_calls": args.label, "card": card(),
                      "m": args.m, "ms": sweep(args.m, reps=args.reps)}),
          flush=True)


if __name__ == "__main__":
    main()
