#!/usr/bin/env python3
"""Smoke run of tsqr_tpu_torch on one NVIDIA GPU: build the stream and
panel kernels, hold each against its plain PyTorch version, drive the
predictive ladder at the bench shape (2^20, 128) through tier 1 and,
with a zeroed column, through tier 4 (the Householder tree on the panel
kernel), run it at tiers 2 and 3, run BlockQR past one panel at
(2^18, 512), and print the ``kernels`` JSON line and a last JSON line
with the device.

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
from tsqr_tpu_torch.core import tsqr as tsqr_mod  # noqa: E402
from tsqr_tpu_torch.ops import _build, gram_stream as gs  # noqa: E402
from tsqr_tpu_torch.ops import panel_kernel as pk  # noqa: E402
from tsqr_tpu_torch.utils import latms, timing, validation  # noqa: E402

N = 128
M_MAIN = 1 << 20
M_CHECK = 1 << 16
M_TIERS = 1 << 18
MODE = "bf16x6_cor"
SOURCE = "tsqr_tpu_torch/ops/csrc/stream_gram.cu"
PANEL_SOURCE = "tsqr_tpu_torch/ops/csrc/panel_qr.cu"
KERNELS = ("stream_gram", "panel_qr")
TOL = {"fp32": 1e-6, "bf16x6_cor": 1e-6, "bf16x3_cor": 1e-5, "bf16": 4e-3}
ZERO_COL = 33        # the tier-4 path's zeroed column
M_WIDE, N_WIDE = 1 << 18, 512
# panel kernel against its plain version: the two sum in other orders
# (warp reductions against batched matmuls), which moves Q and R of a
# well-conditioned tile by a few ulps of the mode times sqrt(L); each
# tile's orthogonality and residual are held to the mode's grade
# (core/auto.py _TOL)
PANEL_TOL = {"fp32": 1e-5, "bf16x6_cor": 1e-5, "bf16x3_cor": 1e-4}
PANEL_CASES = ((264, 256, 128), (64, 256, 64), (33, 200, 50))


def rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.double(), ref.double()
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def reset_counts() -> None:
    gs.LAUNCHES = 0
    gs.REDUCE_LAUNCHES = 0
    pk.LAUNCHES = 0


def read_counts() -> dict:
    return {"stream_gram": gs.LAUNCHES,
            "stream_gram_reduce": gs.REDUCE_LAUNCHES,
            "panel_qr": pk.LAUNCHES}


def phase_card() -> None:
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(line, flush=True)


def ptxas_lines(log: str) -> list[str]:
    """Each entry function's registers and spills from ptxas -v."""
    out, name, stack = [], "?", ""
    for ln in log.splitlines():
        if "Function properties for" in ln:
            name = ln.rsplit(" ", 1)[-1]
        elif "stack frame" in ln:
            stack = ln.strip()
        elif "Used" in ln and "registers" in ln:
            out.append(f"{name}: {ln.split('Used', 1)[1].strip()}; {stack}")
    return out


def phase_build() -> None:
    """Both kernels, one nvcc each, started together; each kernel's
    registers and spills from ptxas, and the panel kernel's dynamic
    shared memory (ptxas sees none: it is sized at launch)."""
    t0 = time.perf_counter()
    _build.build(KERNELS)
    print(f"build: {time.perf_counter() - t0:.2f} s for {len(KERNELS)} "
          "sources in parallel", flush=True)
    for name in KERNELS:
        log = _build.library_path(name).with_suffix(".log").read_text()
        print(f"build: {name}.cu (nvcc "
              f"{_build.BUILD_SECONDS.get(name, 0.0):.2f} s); "
              + " | ".join(ptxas_lines(log)), flush=True)
    print(f"build: panel_qr dynamic shared memory {pk.smem_bytes(256, N)} B "
          f"a CTA at (L, n) = (256, {N}); largest L at n = {N}: "
          f"{pk.max_leaf_rows(N)} ({pk.smem_bytes(pk.max_leaf_rows(N), N)} "
          f"B of {pk._SMEM_MAX})", flush=True)


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
    counts = read_counts()
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


def tile_metrics(a, qt, r) -> tuple[float, float]:
    """The worst tile's orthogonality ||Q^T Q - I||_F / sqrt(n) and
    residual ||A - QR||_F / ||A||_F, in float64 on the card."""
    q64, r64, a64 = qt.double().transpose(1, 2), r.double(), a.double()
    n = q64.shape[-1]
    eye = torch.eye(n, dtype=torch.float64, device=a.device)
    orth = torch.linalg.norm(q64.transpose(1, 2) @ q64 - eye, dim=(1, 2))
    res = (torch.linalg.norm(a64 - q64 @ r64, dim=(1, 2))
           / torch.linalg.norm(a64, dim=(1, 2)).clamp_min(1e-300))
    return float(orth.max()) / math.sqrt(n), float(res.max())


def compare_panel(a, mode, what) -> float:
    """Panel kernel against its plain version on the same tiles; returns
    the max abs error over Q^T and R."""
    qt, r = pk.panel_qr_batched(a, mode)
    qt0, r0 = pk.panel_qr_reference(a, mode)
    torch.cuda.synchronize()
    tol = PANEL_TOL[mode]
    for name, x, y in (("R", r, r0), ("Q^T", qt, qt0)):
        e = rel(x, y)
        if not e <= tol:
            raise AssertionError(f"{what}: rel err of {name} {e:.3e} > {tol:g}")
    if not torch.equal(torch.tril(r, -1), torch.zeros_like(r)):
        raise AssertionError(f"{what}: R has nonzeros below the diagonal")
    orth, res = tile_metrics(a, qt, r)
    if not (orth < tol and res < tol):
        raise AssertionError(f"{what}: orth {orth:.2e} residual {res:.2e}")
    return max(float((qt.double() - qt0.double()).abs().max()),
               float((r.double() - r0.double()).abs().max()))


def phase_panel_vs_plain(gen) -> None:
    """The panel kernel at three tile shapes and three modes; the
    (64, 256, 64) tiles have a zero column, the (33, 200, 50) tiles zero
    rows below row 150, whose Q rows must be exactly 0."""
    for b, L, n in PANEL_CASES:
        a = torch.rand(b, L, n, device="cuda", generator=gen) * 2 - 1
        if n == 64:
            a[:, :, 7] = 0.0
        if n == 50:
            a[:, 150:, :] = 0.0
        for mode in PANEL_TOL:
            what = f"panel ({b}, {L}, {n}) {mode}"
            compare_panel(a, mode, what)
            if n == 50:
                qt, _ = pk.panel_qr_batched(a, mode)
                if not bool((qt[:, :, 150:] == 0).all()):
                    raise AssertionError(f"{what}: zero rows give nonzero Q")
    print(f"panel vs plain: {len(PANEL_CASES) * len(PANEL_TOL)} checks at "
          f"{PANEL_CASES} x {tuple(PANEL_TOL)} within tolerance; zero "
          "column and zero rows ok", flush=True)


def phase_tier4(gen) -> dict:
    """The ladder on the bench shape with one zeroed column: tiers 0-3
    fail their gates and tier 4 runs BlockQR (CGS2, one panel) over two
    Householder trees whose leaves are the panel kernel."""
    a = torch.rand(M_MAIN, N, device="cuda", generator=gen) * 2 - 1
    a[:, ZERO_COL] = 0.0
    torch.cuda.synchronize()
    reset_counts()
    q, r, info = tsqr_tpu_torch.qr_auto_fused(a, MODE, return_info=True)
    torch.cuda.synchronize()
    counts = read_counts()
    orth = validation.orthogonality_accurate(q)
    res = validation.residual_accurate(a, q, r)
    if info["tier"] != 4:
        raise AssertionError(f"tier-4 path took tier {info['tier']}")
    if not (orth < 1e-5 and res < 1e-5):
        raise AssertionError(f"tier-4 path orth {orth:.2e} residual "
                             f"{res:.2e}")
    if counts["panel_qr"] < 2 or counts["stream_gram"] < 1:
        raise AssertionError(f"tier-4 path launches {counts}")
    del q, r
    ladder = timing.time_cuda(lambda: tsqr_tpu_torch.qr_auto_fused(a, MODE),
                              reps=3, warmup=1)
    blockqr_ms = float(np.median(timing.time_cuda(
        lambda: tsqr_tpu_torch.qr(a, MODE, reorth=True), reps=3, warmup=1)))
    tree_ms = float(np.median(timing.time_cuda(
        lambda: tsqr_tpu_torch.tsqr(a, MODE), reps=3, warmup=1)))
    tree_r_ms = float(np.median(timing.time_cuda(
        lambda: tsqr_tpu_torch.tsqr(a, MODE, want_q=False), reps=3,
        warmup=1)))
    qr_ms = float(np.median(timing.time_cuda(
        lambda: torch.linalg.qr(a), reps=4, warmup=1)))
    bs, L, _ = tsqr_mod.plan_tree(M_MAIN, N, pk.max_leaf_rows(N),
                                  tsqr_mod.DEFAULT_FANIN)
    print(json.dumps({
        "tier4_path": f"qr_auto_fused({M_MAIN}x{N} f32, column {ZERO_COL} "
                      f"zeroed, {MODE})",
        "tier": info["tier"], "orthogonality": orth, "residual": res,
        "launches": counts, "leaves": [bs, L, N],
        "fanin": tsqr_mod.DEFAULT_FANIN,
        "ladder_ms_median": float(np.median(ladder)), "ladder_ms": ladder,
        "blockqr_reorth_ms": blockqr_ms, "one_tree_ms": tree_ms,
        "one_tree_r_only_ms": tree_r_ms,
        "torch_linalg_qr_ms": qr_ms}), flush=True)
    return {"a": a, "counts": counts, "leaves": (bs, L)}


def phase_qr_wide(gen) -> None:
    """BlockQR past one panel: four 128-wide panels, CGS2, unrolled."""
    a = torch.rand(M_WIDE, N_WIDE, device="cuda", generator=gen) * 2 - 1
    reset_counts()
    q, r = tsqr_tpu_torch.qr(a, "fp32", reorth=True)
    torch.cuda.synchronize()
    counts = read_counts()
    orth = validation.orthogonality_accurate(q)
    res = validation.residual_accurate(a, q, r)
    if not (orth < 1e-5 and res < 1e-5):
        raise AssertionError(f"qr ({M_WIDE}, {N_WIDE}) orth {orth:.2e} "
                             f"residual {res:.2e}")
    del q, r
    ms = timing.time_cuda(lambda: tsqr_tpu_torch.qr(a, "fp32", reorth=True),
                          reps=3, warmup=1)
    qr_ms = float(np.median(timing.time_cuda(
        lambda: torch.linalg.qr(a), reps=3, warmup=1)))
    bs, L, m_pad = tsqr_mod.plan_tree(M_WIDE, N, pk.max_leaf_rows(N),
                                      tsqr_mod.DEFAULT_FANIN)
    print(json.dumps({"qr_path": f"qr({M_WIDE}x{N_WIDE} f32, fp32, "
                                 "reorth=True)",
                      "orthogonality": orth, "residual": res,
                      "launches": counts, "leaves_per_tree": [bs, L, N],
                      "padded_rows": m_pad - M_WIDE,
                      "ms_median": float(np.median(ms)),
                      "ms": ms, "torch_linalg_qr_ms": qr_ms}), flush=True)


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


def panel_entry(tier4: dict) -> dict:
    """The panel kernel at the tier-4 path's leaf shape: the zero-column
    input cut into its leaves, as the first tree's leaf launch sees it."""
    bs, L = tier4["leaves"]
    leaves = tier4["a"].reshape(bs, L, N)
    err = compare_panel(leaves, MODE, f"panel main-shape ({bs}, {L}, {N})")
    k_ms = float(np.median(timing.time_cuda(
        lambda: pk.panel_qr_batched(leaves, MODE), reps=5, warmup=1)))
    mode_ms = {md: float(np.median(timing.time_cuda(
        lambda md=md: pk.panel_qr_batched(leaves, md), reps=3, warmup=1)))
        for md in ("fp32", "bf16x3_cor")}
    p_ms = float(np.median(timing.time_cuda(
        lambda: pk.panel_qr_reference(leaves, MODE), reps=2, warmup=1)))
    lib_ms = float(np.median(timing.time_cuda(
        lambda: torch.linalg.qr(leaves), reps=3, warmup=1)))
    bound = flops.panel_bound(bs, L, N, MODE)
    return {"name": "panel_qr", "route": "cuda", "source": PANEL_SOURCE,
            "replaces": "tsqr_tpu/ops/pallas_panel_sb.py:149 (B2); also "
                        "tsqr_tpu/ops/pallas_panel.py:129 (B3) and "
                        "docs/attic/pallas_panel_mt.py:194 (B4)",
            "launches": tier4["counts"]["panel_qr"], "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "library_ms": lib_ms,
            "shapes": f"({bs}, {L}, {N}) f32 {MODE} leaves of the tier-4 "
                      "path; library_ms is batched torch.linalg.qr",
            "other_modes_ms": mode_ms}


def phase_kernels_line(a, counts, gen, tier4: dict) -> None:
    """Every kernel of the main paths at the main paths' shapes: its time,
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
        panel_entry(tier4),
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
    phase_panel_vs_plain(gen)
    main_run = phase_main(gen)
    tier4 = phase_tier4(gen)
    phase_tiers(args.seed)
    phase_qr_wide(gen)
    phase_gram_error(main_run["a"])
    phase_kernels_line(main_run["a"], main_run["counts"], gen, tier4)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
