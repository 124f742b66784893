"""Sweep entry point: prints a provenance banner to stderr, then runs one
sweep on the card.

Counterpart of ``tsqr_tpu/harness/main.py``:

  python -m tsqr_tpu_torch.harness.main accuracy [--quick] [--modes ...]
  python -m tsqr_tpu_torch.harness.main cond [--quick] [--modes ...]
  python -m tsqr_tpu_torch.harness.main eval_q [--quick] [--modes ...]
  python -m tsqr_tpu_torch.harness.main baseline [--quick]
  python -m tsqr_tpu_torch.harness.main profile [--quick]
  python -m tsqr_tpu_torch.harness.main mfu [--quick]
  python -m tsqr_tpu_torch.harness.main speed [--quick] [--modes ...]
  python -m tsqr_tpu_torch.harness.main ladder [--quick]

``accuracy``, ``cond`` and ``eval_q`` are the reference's accuracy
experiments over BlockQR (``harness/{accuracy,cond,eval_q}.py``),
``baseline`` measures ``torch.linalg.qr`` with the accuracy and speed
protocols, ``profile`` splits the TSQR tree and BlockQR into their
phases; ``mfu`` sweeps the CholeskyQR pipelines (``harness/mfu.py``),
``speed`` BlockQR (``harness/speed.py``), and ``ladder`` runs the
predictive ladder with its fused methods at kappa = 1, 1e4 and 1e7.
The grids and defaults are the JAX package's.  Every choice runs on the
card and exits with a message where there is none; the row functions
take ``device="cpu"``.  The exit code is 1 when a sweep printed an
error row.
"""

from __future__ import annotations

import argparse
import sys

import torch

from tsqr_tpu_torch.utils import status

FULL_MS = [1 << k for k in range(10, 16)]
FULL_NS = [1 << k for k in range(4, 11)]
MODES = ["fp32", "bf16_nocor", "bf16x3_nocor", "bf16x3_cor", "bf16x6_cor"]
QUICK_MS = [1 << 12]
QUICK_NS = [16, 128]
TIER_NAMES = {1: "fast", 2: "robust", 3: "iter", 4: "householder"}


def ladder(quick: bool, seed: int = 0) -> None:
    """The predictive ladder at (2^20, 128) ((2^14, 64) with ``quick``),
    ``bf16x6_cor``, fused methods, at kappa = 1 (uniform[-1, 1]), 1e4 and
    1e7 (latms): the tier taken, the kappa^2 bound, orthogonality and
    residual."""
    from tsqr_tpu_torch.core import auto
    from tsqr_tpu_torch.utils import latms, validation

    m, n = (1 << 14, 64) if quick else (1 << 20, 128)
    for kappa in (1.0, 1e4, 1e7):
        if kappa == 1.0:
            gen = torch.Generator(device="cuda").manual_seed(seed)
            a = torch.rand(m, n, device="cuda", generator=gen) * 2 - 1
        else:
            a = torch.from_numpy(latms.rand_matrix_with_cond(
                int(kappa), m, n, kappa)[0]).cuda()
        q, r, info = auto.qr_auto_fused(
            a, "bf16x6_cor", fast_method="cholqr1_fused",
            mid_method="cholqr3_fused", mid_variant="compact",
            return_info=True)
        orth = validation.orthogonality_accurate(q)
        resid = validation.residual_accurate(a, q, r)
        print(f"kappa={kappa:8.1e}  tier={TIER_NAMES[info['tier']]:<11s}  "
              f"kappa2_est={float(info['kappa2_est']):.3g}  "
              f"orthogonality={orth:.3e}  residual={resid:.3e}", flush=True)
        del a, q, r


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("which", choices=["accuracy", "speed", "cond", "eval_q",
                                     "baseline", "mfu", "profile",
                                     "ladder"])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--modes", nargs="*", default=MODES)
    p.add_argument("--trials", type=int, default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("harness.main measures on a CUDA card; none found")

    status.print_banner(file=sys.stderr)
    ms = QUICK_MS if args.quick else FULL_MS
    ns = QUICK_NS if args.quick else FULL_NS
    errors = []
    if args.which == "accuracy":
        from tsqr_tpu_torch.harness import accuracy
        _, errors = accuracy.sweep(
            ms, ns, args.modes, trials=args.trials or (4 if args.quick
                                                       else 16))
    elif args.which == "cond":
        from tsqr_tpu_torch.harness import cond
        conds = ([2.0 ** k for k in (2, 8)] if args.quick
                 else [2.0 ** k for k in range(2, 16)])
        m, n = (1 << 12, 64) if args.quick else (1 << 15, 1 << 7)
        _, errors = cond.sweep(m, n, conds, args.modes,
                               trials=args.trials or (2 if args.quick
                                                      else 4))
    elif args.which == "eval_q":
        from tsqr_tpu_torch.harness import eval_q
        eval_q.sweep(ms, ns[-1], args.modes)
    elif args.which == "baseline":
        from tsqr_tpu_torch.harness import baseline
        baseline.accuracy_sweep(ms, ns, trials=args.trials or (
            4 if args.quick else 16))
        baseline.speed_sweep(ms, ns, out=sys.stderr)
    elif args.which == "profile":
        from tsqr_tpu_torch.harness import profile
        m = 1 << (14 if args.quick else 20)
        profile.tsqr_phase_split(m, 128, "fp32", out=sys.stdout)
        profile.blockqr_breakdown(m, 512, "fp32", out=sys.stdout)
    elif args.which == "mfu":
        from tsqr_tpu_torch.harness import mfu
        _, errors = mfu.sweep(m=(1 << 16) if args.quick else (1 << 20),
                              ns=(128,) if args.quick
                              else (128, 256, 512, 1024, 2048))
    elif args.which == "speed":
        from tsqr_tpu_torch.harness import speed
        _, errors = speed.sweep(ms, ns, args.modes,
                                trials=args.trials or 8)
    else:
        ladder(args.quick)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
