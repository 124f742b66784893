#!/usr/bin/env python3
"""Headline benchmark of tsqr_tpu_torch on one NVIDIA GPU: the predictive
ladder ``qr_auto_fused(a, "bf16x6_cor")`` at (2^20, 128) over K = 6
distinct resident inputs, gated on orthogonality < 1e-5.

Prints one JSON line as the last line of stdout:
  {"metric": "qr_auto_bf16x6_cor_tflops", "value": <useful TFLOP/s>,
   "unit": "TFLOP/s", "vs_baseline": <speed-up over torch.linalg.qr>}
and, on stderr, the card and its power limit, the gate's orthogonality
and tier, every timed window with the spread, the yardstick, and the
(2^21, 128) K = 4 rung.  Exits non-zero without a CUDA device.

    python3 bench_torch.py
    python3 bench_torch.py --single M K [--no-iter] [--device cpu]

The program is ``tsqr_tpu_torch/harness/bench.py``; ``--device cpu`` is
for tests.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from tsqr_tpu_torch.harness import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(sys.argv[1:]))
