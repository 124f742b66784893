"""Where the stream kernel's time goes, phase by phase, on the card.

Builds ``stream_gram.cu`` with ``-DSTREAM_GRAM_PROFILE`` (clock64 phase
timers, thread 0 of each CTA), runs the main path's call kinds once each
at (m, 128) and prints, per call kind, the median kernel ms and each
phase's share of the CTAs' mean cycles, as one JSON line each:

    python -m tsqr_tpu_torch.harness.phase_profile [--m 1048576]

The timers cost a few percent; the ms printed here are of the
instrumented build, not of the shipped one.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

PHASE_NAMES = ("top_sync", "tile_load", "dot_split+sync", "r_slab_load",
               "r_slab_sync", "dot_mma", "x_update+sync", "q_write",
               "gram_split+sync", "gram")
MAX_PROFILED_CTAS = 1024


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=1 << 20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("phase_profile measures on a CUDA device")
    import tsqr_tpu_torch  # noqa: F401  (TF32 off)
    from tsqr_tpu_torch.ops import gram_stream as gs
    from tsqr_tpu_torch.utils import timing

    gs.BUILD_DEFINES = ("STREAM_GRAM_PROFILE",)
    lib = gs._lib()
    lib.stream_gram_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.stream_gram_phase_cycles.restype = ctypes.c_int
    buf = np.zeros((MAX_PROFILED_CTAS, len(PHASE_NAMES)), np.int64)
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.rand(args.m, 128, device="cuda", generator=gen) * 2 - 1
    eye = torch.eye(128, device="cuda")
    md = "bf16x6_cor"
    calls = {
        "gram x6": dict(gram_mode=md),
        "qpass x6": dict(rinvs=(eye,), dot_modes=(md,), write_q=True),
        "dot+gram x6": dict(rinvs=(eye,), dot_modes=(md,), gram_mode=md),
        "gram fp32": dict(gram_mode="fp32"),
    }
    for label, cfg in calls.items():
        ms = timing.median_ms(lambda: gs.stream(a, **cfg))
        grid = gs.grid_size(args.m, 128, len(cfg.get("rinvs", ())),
                            gs._kernel_code(gs._mode(cfg["gram_mode"]))
                            if "gram_mode" in cfg else -1)
        gs.stream(a, **cfg)
        torch.cuda.synchronize()
        if lib.stream_gram_phase_cycles(buf.ctypes.data):
            raise RuntimeError("reading the phase timers failed")
        per_cta = buf[:min(grid, MAX_PROFILED_CTAS)].astype(np.float64)
        total = per_cta.sum(axis=1).mean()
        print(json.dumps({
            "call": label, "m": args.m, "ms": ms, "ctas": grid,
            "cycles_per_cta": total,
            "share": {n: round(float(per_cta[:, i].mean() / total), 4)
                      for i, n in enumerate(PHASE_NAMES)
                      if per_cta[:, i].any()}}), flush=True)


if __name__ == "__main__":
    main()
