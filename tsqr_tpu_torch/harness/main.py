"""Sweep entry point: prints a provenance banner to stderr, then runs one
sweep on the card.

Counterpart of ``tsqr_tpu/harness/main.py`` for the choices ported so
far:

  python -m tsqr_tpu_torch.harness.main mfu [--quick]
  python -m tsqr_tpu_torch.harness.main speed [--quick] [--modes ...]
  python -m tsqr_tpu_torch.harness.main ladder [--quick]

``mfu`` sweeps the CholeskyQR pipelines (``harness/mfu.py``), ``speed``
BlockQR (``harness/speed.py``), and ``ladder`` runs the predictive
ladder with its fused methods at kappa = 1, 1e4 and 1e7.  The exit code
is 1 when a sweep printed an error row.
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
    p.add_argument("which", choices=["mfu", "speed", "ladder"])
    p.add_argument("--quick", action="store_true")
    p.add_argument("--modes", nargs="*", default=MODES)
    p.add_argument("--trials", type=int, default=8)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("harness.main measures on a CUDA card; none found")

    status.print_banner(file=sys.stderr)
    errors = []
    if args.which == "mfu":
        from tsqr_tpu_torch.harness import mfu
        _, errors = mfu.sweep(m=(1 << 16) if args.quick else (1 << 20),
                              ns=(128,) if args.quick
                              else (128, 256, 512, 1024, 2048))
    elif args.which == "speed":
        from tsqr_tpu_torch.harness import speed
        _, errors = speed.sweep(QUICK_MS if args.quick else FULL_MS,
                                QUICK_NS if args.quick else FULL_NS,
                                args.modes, trials=args.trials)
    else:
        ladder(args.quick)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
