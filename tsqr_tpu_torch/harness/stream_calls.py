"""Device time of the main paths' kernel calls, per mode, on the card.

Times with CUDA events, at (m, 128) float32:

* ``ops.gram_stream.stream``: the Gram pass and the Q pass at fp32,
  bf16, bf16x3_cor and bf16x6_cor, the ``compact_final`` pass (a
  bf16x6_cor dot, a residual bf16x3_cor dot, Q and the Gram), the Q pass
  written over its input (``alias_q``), the library products ``a.T @ a``
  and ``a @ rinv`` and the reduction stage;
* ``ops.panel_kernel.panel_qr_batched`` on the tier-4 path's leaves (the
  (m / 256, 256, 128) leaves of A with column 33 zeroed) per mode, and on
  (m / 512, 512, 64) leaves at bf16x6_cor, beside batched
  ``torch.linalg.qr``;
* the tier-1 ladder ``qr_auto_fused(a, "bf16x6_cor")`` as exported and
  unwrapped (its ``__wrapped__``, without the gradient rule's decorator),
  in turns over three rounds: the decorator's host time on a call with
  nothing to differentiate.

With ``--wide N`` it times the wide range instead (128 < n <= 2048,
``ops/csrc/stream_wide.cu``) at (m, N): the Gram and the Q pass per
mode, the ``compact_final`` pass at bf16x6_cor, the library products,
the bench's ladder at (m, N), and each
call's device time by kernel from a ``torch.profiler`` trace (the split
pass, the dots, the Gram, the reduction).

Prints one JSON line with the card's name and power limit:

    python -m tsqr_tpu_torch.harness.stream_calls [--m 1048576] [--reps 7]
        [--label X] [--wide N]

The module uses only calls that the package had before the panel
kernel's redesign, so a copy of it can time an older checkout and the
current one in turns on one card.  Nothing here is compared with a
plain version: ``chip_smoke.py`` does that.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess

import numpy as np
import torch

MODES = ("fp32", "bf16", "bf16x3_cor", "bf16x6_cor")
PANEL_MODES = ("bf16x6_cor", "bf16x3_cor", "fp32", "bf16")
LADDER_ROUNDS = 3


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
    del a_alias, part
    out.update(ladder_sweep(a, reps))
    a[:, 33] = 0.0   # the tier-4 cell's input
    out.update(panel_sweep(a, reps))
    return out


def panel_sweep(a: torch.Tensor, reps: int) -> dict:
    """The panel kernel per mode on A's (m / 256, 256, 128) leaves and at
    (m / 512, 512, 64) bf16x6_cor, beside batched torch.linalg.qr."""
    from tsqr_tpu_torch.ops import panel_kernel
    from tsqr_tpu_torch.utils import timing

    def ms(fn, r=reps):
        return float(np.median(timing.time_cuda(fn, reps=r, warmup=1)))

    leaves = a.view(-1, 256, a.shape[1])
    shape = tuple(leaves.shape)
    out = {f"panel {shape} {md}": ms(
        lambda md=md: panel_kernel.panel_qr_batched(leaves, md))
        for md in PANEL_MODES}
    out[f"panel {shape} library torch.linalg.qr"] = ms(
        lambda: torch.linalg.qr(leaves), 3)
    leaves64 = a[:, :64].reshape(-1, 512, 64)
    out[f"panel {tuple(leaves64.shape)} bf16x6_cor"] = ms(
        lambda: panel_kernel.panel_qr_batched(leaves64, "bf16x6_cor"))
    return out


def ladder_sweep(a: torch.Tensor, reps: int) -> dict:
    """The tier-1 ladder as exported and unwrapped, in turns: the median
    of each round's median ms, and every round's."""
    import tsqr_tpu_torch
    from tsqr_tpu_torch.utils import timing

    entry = tsqr_tpu_torch.qr_auto_fused
    entries = {"ladder tier 1": entry,
               "ladder tier 1 unwrapped": getattr(entry, "__wrapped__",
                                                  entry)}
    rounds: dict = {k: [] for k in entries}
    for _ in range(LADDER_ROUNDS):
        for k, fn in entries.items():
            rounds[k].append(float(np.median(timing.time_cuda(
                lambda fn=fn: fn(a, "bf16x6_cor"), reps=reps + 2,
                warmup=2))))
    out = {k: float(np.median(v)) for k, v in rounds.items()}
    out.update({f"{k} rounds": v for k, v in rounds.items()})
    return out


def wide_sweep(m: int, n: int, reps: int = 7) -> dict:
    """The wide range at (m, n): each call kind's ms, the library
    products', the bench's ladder's, and each kind's kernels' device ms
    from a trace of one call."""
    import tempfile

    from tsqr_tpu_torch.harness import bench, profile
    from tsqr_tpu_torch.ops import gram_stream as gs
    from tsqr_tpu_torch.utils import timing

    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.rand(m, n, device="cuda", generator=gen) * 2 - 1
    kinds = {k: c for k, c in calls(a, n).items() if not c.get("alias_q")}
    out, kernels = {}, {}
    with tempfile.TemporaryDirectory() as logdir:
        for label, cfg in kinds.items():
            out[label] = float(np.median(timing.time_cuda(
                lambda c=cfg: gs.stream(a, **c), reps=reps, warmup=2)))
            with profile.trace(logdir) as tr:
                gs.stream(a, **cfg)
            kernels[label] = {k["name"].split("(")[0]: round(k["total_ms"], 4)
                              for k in tr.summary(top=6)["top"]}
    rinv = kinds["qpass fp32"]["rinvs"][0]
    out["library a.T@a"] = float(np.median(timing.time_cuda(
        lambda: a.T @ a, reps=reps, warmup=2)))
    out["library a@rinv"] = float(np.median(timing.time_cuda(
        lambda: a @ rinv, reps=reps, warmup=2)))
    out["ladder tier 1"] = float(np.median(timing.time_cuda(
        lambda: bench.ladder(a), reps=reps, warmup=2)))
    out["kernels"] = kernels
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=1 << 20)
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--label", default="")
    ap.add_argument("--wide", type=int, default=0, metavar="N",
                    help="time the wide range at n = N instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stream_calls measures on a CUDA device")
    if args.wide:
        print(json.dumps({"stream_calls_wide": args.label, "card": card(),
                          "m": args.m, "n": args.wide,
                          "ms": wide_sweep(args.m, args.wide, args.reps)}),
              flush=True)
        return
    print(json.dumps({"stream_calls": args.label, "card": card(),
                      "m": args.m, "ms": sweep(args.m, reps=args.reps)}),
          flush=True)


if __name__ == "__main__":
    main()
