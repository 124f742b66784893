"""Where the stream kernel's or the panel kernel's time goes, phase by
phase, on the card.

Builds ``stream_gram.cu`` with ``-DSTREAM_GRAM_PROFILE`` (or, with
``--kernel panel``, ``panel_qr.cu`` with ``-DPANEL_QR_PROFILE``): clock64
phase timers, thread 0 of each CTA.  It runs the main path's call kinds
once each at (m, 128) (the panel kernel: the tier-4 leaves of an (m, 128)
input, (m / 256, 256, 128), at bf16x6_cor and fp32) and prints, per call,
the median kernel ms and each phase's share of the CTAs' mean cycles, as
one JSON line each:

    python -m tsqr_tpu_torch.harness.phase_profile [--m 1048576]
        [--kernel stream|panel]

The timers cost a few percent; the ms printed here are of the
instrumented build, not of the shipped one.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

PHASE_NAMES = ("ring_wait", "alias_arrive", "r_image_copy", "dot_split",
               "dot_products", "gram_split", "q_write", "gram_products",
               "chunk_fold", "tile_end+setup")
PANEL_PHASES = ("load", "chain_reduce+barrier", "chain_update",
                "y_split", "factor_dots", "form_w", "factor_update",
                "r_write", "q_y_split", "q_dots", "q_update", "q_write")
MAX_PROFILED_CTAS = 1024


def _shares(per_cta: np.ndarray, names) -> tuple[float, dict]:
    total = per_cta.sum(axis=1).mean()
    return total, {n: round(float(per_cta[:, i].mean() / total), 4)
                   for i, n in enumerate(names) if per_cta[:, i].any()}


def panel(m: int) -> None:
    """The panel kernel's phases on the tier-4 path's leaves."""
    from tsqr_tpu_torch.ops import panel_kernel as pk
    from tsqr_tpu_torch.utils import timing

    pk.BUILD_DEFINES = ("PANEL_QR_PROFILE",)
    lib = pk._lib()
    lib.panel_qr_phase_cycles.argtypes = [ctypes.c_void_p]
    lib.panel_qr_phase_cycles.restype = ctypes.c_int
    buf = np.zeros((MAX_PROFILED_CTAS, len(PANEL_PHASES)), np.int64)
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.rand(m, 128, device="cuda", generator=gen) * 2 - 1
    a[:, 33] = 0.0
    leaves = a.view(-1, 256, 128)
    for mode in ("bf16x6_cor", "fp32"):
        ms = timing.median_ms(lambda: pk.panel_qr_batched(leaves, mode))
        pk.panel_qr_batched(leaves, mode)
        torch.cuda.synchronize()
        if lib.panel_qr_phase_cycles(buf.ctypes.data):
            raise RuntimeError("reading the phase timers failed")
        per_cta = buf[:min(leaves.shape[0], MAX_PROFILED_CTAS)].astype(
            np.float64)
        total, share = _shares(per_cta, PANEL_PHASES)
        print(json.dumps({"call": f"panel {tuple(leaves.shape)} {mode}",
                          "ms": ms, "cycles_per_cta": total,
                          "share": share}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=1 << 20)
    ap.add_argument("--kernel", choices=("stream", "panel"),
                    default="stream")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("phase_profile measures on a CUDA device")
    import tsqr_tpu_torch  # noqa: F401  (TF32 off)
    if args.kernel == "panel":
        panel(args.m)
        return
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
        grid = gs.grid_size(
            args.m, 128, [gs._kernel_code(gs._mode(d))
                          for d in cfg.get("dot_modes", ())],
            gs._kernel_code(gs._mode(cfg["gram_mode"]))
            if "gram_mode" in cfg else -1)
        gs.stream(a, **cfg)
        torch.cuda.synchronize()
        if lib.stream_gram_phase_cycles(buf.ctypes.data):
            raise RuntimeError("reading the phase timers failed")
        per_cta = buf[:min(grid, MAX_PROFILED_CTAS)].astype(np.float64)
        total, share = _shares(per_cta, PHASE_NAMES)
        print(json.dumps({
            "call": label, "m": args.m, "ms": ms, "ctas": grid,
            "cycles_per_cta": total, "share": share}), flush=True)


if __name__ == "__main__":
    main()
