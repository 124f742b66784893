#!/usr/bin/env python3
"""Smoke run of tsqr_tpu_torch on one NVIDIA GPU: build the stream kernel,
hold it against its plain PyTorch version, drive the predictive ladder at
the bench shape (2^20, 128) and at tiers 2 and 3, and print one JSON line
per kernel and a last JSON line with the device.

    python3 chip_smoke.py [--seed N]

Run it from the root of a checkout.  Every phase passes or raises; any
failure exits non-zero before the last line is printed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import tsqr_tpu_torch  # noqa: E402
from tsqr_tpu_torch.harness import flops  # noqa: E402
from tsqr_tpu_torch.ops import _build, gram_stream as gs  # noqa: E402
from tsqr_tpu_torch.utils import latms, timing, validation  # noqa: E402

N = 128
M_MAIN = 1 << 20
M_CHECK = 1 << 16
M_TIERS = 1 << 18
MODE = "bf16x6_cor"
SOURCE = "tsqr_tpu_torch/ops/csrc/stream_gram.cu"
TOL = {"fp32": 1e-6, "bf16x6_cor": 1e-6, "bf16x3_cor": 1e-5, "bf16": 4e-3}


def rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.double(), ref.double()
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def reset_counts() -> None:
    gs.LAUNCHES = 0
    gs.REDUCE_LAUNCHES = 0


def phase_card() -> None:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(line, flush=True)


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load("stream_gram")
    log = _build.library_path("stream_gram").with_suffix(".log")
    regs = [ln.strip() for ln in log.read_text().splitlines()
            if "registers" in ln or "stack frame" in ln]
    print(f"build: stream_gram.cu {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.BUILD_SECONDS.get('stream_gram', 0.0):.2f} s); "
          + " | ".join(regs), flush=True)


def call_sites(mode: str, rinv, delta) -> dict:
    """Each way the ladder calls the stream pass, at one mode."""
    return {
        "gram_only": dict(gram_mode=mode),
        "tier1_qpass": dict(rinvs=(rinv,), dot_modes=(mode,), write_q=True),
        "compact_mid": dict(rinvs=(rinv,), dot_modes=("bf16x3_cor",),
                            gram_mode=mode),
        "compact_f2": dict(rinvs=(rinv,), dot_modes=(mode,), gram_mode=mode),
        "compact_final": dict(rinvs=(rinv, delta),
                              dot_modes=(mode, "bf16x3_cor"),
                              residual=(False, True), write_q=True,
                              gram_mode=mode),
        "tier3_loop": dict(rinvs=(rinv,), dot_modes=(mode,), gram_mode=mode),
        "cheap_chain": dict(rinvs=(rinv,) * 3, dot_modes=(mode,) * 3,
                            write_q=True),
    }


def compare(a, cfg, tol, what) -> float:
    """Kernel against plain version on the same inputs; returns the max
    abs error over the outputs (a Gram compared as G = P + P^T)."""
    got = as_tuple(gs.stream(a, **cfg))
    ref = as_tuple(gs.stream_reference(a, **cfg))
    torch.cuda.synchronize()
    err = 0.0
    for i, (x, y) in enumerate(zip(got, ref)):
        is_gram = cfg.get("gram_mode") is not None and i == len(got) - 1
        if is_gram:
            x, y = x + x.T, y + y.T
        e = rel(x, y)
        if not e <= tol:
            raise AssertionError(f"{what}: rel err {e:.3e} > {tol:g}")
        err = max(err, float((x.double() - y.double()).abs().max()))
    return err


def phase_kernel_vs_plain(gen) -> None:
    a = torch.rand(M_CHECK, N, device="cuda", generator=gen) * 2 - 1
    eye = torch.eye(N, device="cuda")
    rinv = eye + torch.randn(N, N, device="cuda", generator=gen) / (
        4 * math.sqrt(N))
    delta = 1e-3 * torch.randn(N, N, device="cuda", generator=gen) / math.sqrt(N)
    n_checks = 0
    for mode in ("fp32", "bf16x3_cor", "bf16x6_cor"):
        for site, cfg in call_sites(mode, rinv, delta).items():
            compare(a, cfg, TOL[mode], f"{site}/{mode}")
            n_checks += 1
    # a cheap mode on bf16 IO
    ab = a.bfloat16()
    for site, cfg in call_sites("bf16", rinv, delta).items():
        compare(ab, cfg, TOL["bf16"], f"{site}/bf16")
        n_checks += 1
    # bitwise recomputation: a Gram-only launch and a Q-writing launch
    # with the same dots derive identical x
    dots = dict(rinvs=(rinv, delta), dot_modes=(MODE, "bf16x3_cor"),
                residual=(False, True))
    p_gram = gs.stream(a, gram_mode=MODE, **dots)
    q, p_q = gs.stream(a, write_q=True, gram_mode=MODE,
                       out_dtype=torch.float32, **dots)
    p_rederived = gs.stream(q, (eye,), ("fp32",), gram_mode=MODE)
    torch.cuda.synchronize()
    if not (torch.equal(p_gram, p_q) and torch.equal(p_rederived, p_q)):
        raise AssertionError("bitwise recomputation failed")
    print(f"kernel vs plain: {n_checks} call-site checks at ({M_CHECK}, {N}) "
          "within tolerance; bitwise recompute ok", flush=True)


def phase_main(gen) -> dict:
    a = torch.rand(M_MAIN, N, device="cuda", generator=gen) * 2 - 1
    torch.cuda.synchronize()
    reset_counts()
    q, r, info = tsqr_tpu_torch.qr_auto_fused(a, MODE, return_info=True)
    torch.cuda.synchronize()
    counts = {"stream_gram": gs.LAUNCHES,
              "stream_gram_reduce": gs.REDUCE_LAUNCHES}
    orth = validation.orthogonality_accurate(q)
    res = validation.residual_accurate(a, q, r)
    if info["tier"] != 1:
        raise AssertionError(f"main path took tier {info['tier']}, not 1")
    if not (orth < 1e-5 and res < 1e-5):
        raise AssertionError(f"main path orth {orth:.2e} residual {res:.2e}")
    if counts["stream_gram"] < 2 or counts["stream_gram_reduce"] < 1:
        raise AssertionError(f"main path launches {counts}")
    del q, r
    ladder = timing.time_cuda(lambda: tsqr_tpu_torch.qr_auto_fused(a, MODE),
                              reps=7, warmup=2)
    ladder_ms = float(np.median(ladder))
    qr_ms = float(np.median(timing.time_cuda(
        lambda: torch.linalg.qr(a), reps=4, warmup=1)))
    useful = flops.qr_flops(M_MAIN, N)
    print(json.dumps({
        "main_path": f"qr_auto_fused({M_MAIN}x{N} f32, {MODE})",
        "tier": info["tier"], "kappa2_est": float(info["kappa2_est"]),
        "orthogonality": orth, "residual": res, "launches": counts,
        "ladder_ms_median": ladder_ms, "ladder_ms": ladder,
        "useful_tflops": useful / ladder_ms / 1e9,
        "torch_linalg_qr_ms": qr_ms,
        "torch_linalg_qr_tflops": useful / qr_ms / 1e9}), flush=True)
    return {"a": a, "counts": counts}


def phase_tiers(seed: int) -> None:
    for kappa, want in ((1024, 2), (1 << 18, 3)):
        a_np, measured = latms.rand_matrix_with_cond(seed + kappa, M_TIERS,
                                                     N, kappa)
        a = torch.from_numpy(a_np).cuda()
        reset_counts()
        q, r, info = tsqr_tpu_torch.qr_auto_fused(a, MODE, return_info=True)
        torch.cuda.synchronize()
        launches = gs.LAUNCHES
        orth = validation.orthogonality_accurate(q)
        res = validation.residual_accurate(a, q, r)
        ms = float(np.median(timing.time_cuda(
            lambda: tsqr_tpu_torch.qr_auto_fused(a, MODE), reps=3,
            warmup=1)))
        print(json.dumps({"tier_path": f"kappa={kappa}", "m": M_TIERS,
                          "kappa_measured": measured, "tier": info["tier"],
                          "orthogonality": orth, "residual": res,
                          "stream_launches": launches, "ladder_ms": ms}),
              flush=True)
        if info["tier"] != want or not orth < 1e-5:
            raise AssertionError(f"kappa={kappa}: tier {info['tier']} "
                                 f"(want {want}), orth {orth:.2e}")


def phase_gram_error(a) -> None:
    """The kernel's Gram error against float64, beside the shift budget
    of cholqr._shift_value_fused (~sqrt(chunk) eps ||G||)."""
    a64 = a.double()
    g64 = a64.T @ a64
    out = {}
    for mode in ("bf16x6_cor", "fp32"):
        g = gs.gram_stream(a, mode).double()
        out[mode] = float(torch.linalg.norm(g - g64) / torch.linalg.norm(g64))
    chunk = gs.effective_chunk(M_MAIN, N)
    out["budget_sqrt_chunk_eps"] = math.sqrt(chunk) * 6e-8
    out["chunk"] = chunk
    print(json.dumps({"gram_rel_err_vs_fp64": out}), flush=True)
    del a64, g64


def phase_kernels_line(a, counts, gen) -> None:
    """Every kernel of the main path at the main path's shapes: its time,
    its plain version's time, the library call's time and the bound."""
    g = gs.gram_stream(a, MODE)
    rinv = torch.linalg.solve_triangular(
        torch.linalg.cholesky(g).T, torch.eye(N, device="cuda"), upper=True)
    calls = [dict(gram_mode=MODE),
             dict(rinvs=(rinv,), dot_modes=(MODE,), write_q=True)]
    bounds = [flops.stream_bound(M_MAIN, N, gram_mode=MODE),
              flops.stream_bound(M_MAIN, N, (MODE,), write_q=True)]
    err = max(compare(a, cfg, TOL[MODE], "main-shape") for cfg in calls)
    k_ms = [float(np.median(timing.time_cuda(lambda c=c: gs.stream(a, **c))))
            for c in calls]
    p_ms = [float(np.median(timing.time_cuda(
        lambda c=c: gs.stream_reference(a, **c), reps=2, warmup=1)))
        for c in calls]
    lib_ms = [float(np.median(timing.time_cuda(lambda: a.T @ a))),
              float(np.median(timing.time_cuda(lambda: a @ rinv)))]
    t_bytes = sum(b["bytes"] for b in bounds) / flops.H100_BYTES_PER_S
    t_ops = sum(b["bf16_flops"] / flops.H100_BF16_FLOPS
                + b["fp32_flops"] / flops.H100_FP32_FLOPS for b in bounds)

    # the reduction stage at the main path's shape: one float64 (n, n)
    # partial per CTA of a Gram launch
    grid = gs.grid_size(M_MAIN, N, 0, gs._kernel_code(gs._mode(MODE)))
    part = torch.randn(grid, N, N, dtype=torch.float64, device="cuda",
                       generator=gen)
    red = gs.reduce_partials(part)
    red_ref = part.sum(0).float()
    red_err = float((red.double() - red_ref.double()).abs().max())
    if not rel(red, red_ref) <= 1e-6:
        raise AssertionError("reduction stage disagrees with torch.sum")
    r_ms = float(np.median(timing.time_cuda(lambda: gs.reduce_partials(part))))
    r_plain = float(np.median(timing.time_cuda(
        lambda: part.sum(0).float())))
    r_lib = float(np.median(timing.time_cuda(lambda: part.sum(0))))
    r_bytes = part.numel() * 8 + N * N * 4
    kernels = [
        {"name": "stream_gram", "route": "cuda", "source": SOURCE,
         "replaces": "tsqr_tpu/ops/pallas_gram.py:196",
         "launches": counts["stream_gram"], "max_abs_err": err,
         "ms": sum(k_ms), "plain_ms": sum(p_ms),
         "bound_ms": 1e3 * max(t_bytes, t_ops),
         "bound_by": "bytes" if t_bytes >= t_ops else "operations",
         "library_ms": sum(lib_ms),
         "shapes": f"tier-0 Gram + tier-1 Q pass at ({M_MAIN}, {N}) {MODE}",
         "per_call_ms": {"gram": k_ms[0], "qpass": k_ms[1]},
         "per_call_plain_ms": {"gram": p_ms[0], "qpass": p_ms[1]},
         "per_call_bound_ms": {"gram": bounds[0]["bound_ms"],
                               "qpass": bounds[1]["bound_ms"]},
         "per_call_library_ms": {"a.T@a": lib_ms[0], "a@rinv": lib_ms[1]}},
        {"name": "stream_gram_reduce", "route": "cuda", "source": SOURCE,
         "replaces": "tsqr_tpu/ops/pallas_gram.py:280",
         "launches": counts["stream_gram_reduce"], "max_abs_err": red_err,
         "ms": r_ms, "plain_ms": r_plain,
         "bound_ms": 1e3 * r_bytes / flops.H100_BYTES_PER_S,
         "bound_by": "bytes", "library_ms": r_lib,
         "shapes": f"({part.shape[0]}, {N}, {N}) float64 partials"},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    phase_card()
    phase_build()
    phase_kernel_vs_plain(gen)
    main_run = phase_main(gen)
    phase_tiers(args.seed)
    phase_gram_error(main_run["a"])
    phase_kernels_line(main_run["a"], main_run["counts"], gen)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
