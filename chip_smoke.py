#!/usr/bin/env python3
"""Smoke run of tsqr_tpu_torch on one NVIDIA GPU: build the stream,
panel and bandwidth-probe kernels, hold each against its plain PyTorch
version, drive the predictive ladder at the bench shape (2^20, 128)
through tier 1 and, with a zeroed column, through tier 4 (the
Householder tree on the panel kernel), run it at tiers 2 and 3, run
BlockQR past one panel at (2^18, 512), run the measurement path (the
bandwidth sweep of ``harness.bw`` and the ``harness.mfu`` sweep), the
in-place QR at (2^22, 128), every cholqr2_fused variant and ``qr_auto``,
take gradients through the entry points on the card (the ``grad`` phase:
the ladder, the tree and BlockQR, held against the CPU's), time the stream
kernel's call kinds beside those of the kernel before its redesign, and
print the ``kernels`` JSON line and a last JSON line with the device.

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
from tsqr_tpu_torch.harness import bw, flops, mfu  # noqa: E402
from tsqr_tpu_torch.core import cholqr  # noqa: E402
from tsqr_tpu_torch.core import tsqr as tsqr_mod  # noqa: E402
from tsqr_tpu_torch.ops import _build, bw_probe, gram_stream as gs  # noqa: E402
from tsqr_tpu_torch.ops import panel_kernel as pk  # noqa: E402
from tsqr_tpu_torch.utils import latms, timing, validation  # noqa: E402

N = 128
M_MAIN = 1 << 20
M_CHECK = 1 << 16
M_TIERS = 1 << 18
MODE = "bf16x6_cor"
SOURCE = "tsqr_tpu_torch/ops/csrc/stream_gram.cu"
PANEL_SOURCE = "tsqr_tpu_torch/ops/csrc/panel_qr.cu"
BW_SOURCE = "tsqr_tpu_torch/ops/csrc/bw_probe.cu"
KERNELS = ("stream_gram", "panel_qr", "bw_probe")
M_BW = 1 << 22       # the bandwidth sweep's and the in-place runs' rows
INPLACE_PEAK_MAX = 64 << 20  # bytes a call may allocate above its input
INPLACE_CASES = (("cholqr1_fused", "safe"), ("cholqr2_fused", "compact"),
                 ("cholqr2_fused", "turbo"), ("cholqr3_fused", "compact"))
CHOLQR2_VARIANTS = ("safe", "fast", "fastest", "compact", "turbo")
MFU_NS = (128, 512)
TOL = {"fp32": 1e-6, "bf16x6_cor": 1e-6, "bf16x3_cor": 1e-5, "bf16": 4e-3}
OTHER_MODES = ("fp32", "bf16x3_cor", "bf16")
# The stream kernel's call kinds before its redesign (one CTA per SM,
# Kahan updates every 16 rows), (2^20, 128) f32 A, ms: harness/
# stream_calls.py on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6).
# Printed beside this run's times so that a slower mode or call kind shows.
BEFORE_REDESIGN_MS = {
    "gram fp32": 3.666, "qpass fp32": 6.216, "gram bf16": 3.094,
    "qpass bf16": 5.581, "gram bf16x3_cor": 3.676,
    "qpass bf16x3_cor": 7.197, "gram bf16x6_cor": 3.982,
    "qpass bf16x6_cor": 7.785, "compact_final bf16x6_cor": 18.623,
    "qpass_alias_q bf16x6_cor": 7.744}
ZERO_COL = 33        # the tier-4 path's zeroed column
M_WIDE, N_WIDE = 1 << 18, 512
# panel kernel against its plain version: the two sum in other orders
# (warp reductions against batched matmuls), which moves Q and R of a
# well-conditioned tile by a few ulps of the mode times sqrt(L); each
# tile's orthogonality and residual are held to the mode's grade
# (core/auto.py _TOL)
PANEL_TOL = {"fp32": 1e-5, "bf16x6_cor": 1e-5, "bf16x3_cor": 1e-4}
PANEL_CASES = ((264, 256, 128), (64, 256, 64), (33, 200, 50))
# the grad phase: (m, n), and the cases (entry, mode).  The card's and the
# CPU's factors agree to float32 grade; the rule carries their difference
# through R^{-1}, kappa(A) ~ 5 for these uniform inputs
M_GRAD, N_GRAD = 1 << 14, 64
GRAD_CASES = (("qr_auto_fused", "bf16x6_cor"), ("qr_auto_fused", "fp32"),
              ("tsqr", "bf16x6_cor"), ("qr", "bf16x6_cor"))
GRAD_TOL = 1e-5


def rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.double(), ref.double()
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def reset_counts() -> None:
    gs.LAUNCHES = 0
    gs.ALIAS_LAUNCHES = 0
    gs.REDUCE_LAUNCHES = 0
    pk.LAUNCHES = 0
    bw_probe.READ_LAUNCHES = 0
    bw_probe.READ_SUM_LAUNCHES = 0
    bw_probe.COPY_LAUNCHES = 0


def read_counts() -> dict:
    return {"stream_gram": gs.LAUNCHES,
            "stream_gram_alias_q": gs.ALIAS_LAUNCHES,
            "stream_gram_reduce": gs.REDUCE_LAUNCHES,
            "panel_qr": pk.LAUNCHES,
            "read_reduce": bw_probe.READ_LAUNCHES,
            "read_reduce_sum": bw_probe.READ_SUM_LAUNCHES,
            "copy": bw_probe.COPY_LAUNCHES}


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
    out["budget_sqrt_chunk_eps"] = budget = math.sqrt(chunk) * 6e-8
    out["chunk"] = chunk
    print(json.dumps({"gram_rel_err_vs_fp64": out}), flush=True)
    if not max(out["bf16x6_cor"], out["fp32"]) <= budget:
        raise AssertionError(f"Gram error outside sqrt(chunk) eps: {out}")
    del a64, g64


def phase_bw_vs_plain(gen) -> None:
    """The probes against their plain versions: read_reduce to 1e-6 of a
    float64 sum, copy bit for bit, at the sweep's row counts and ragged
    shapes."""
    for m, n in ((1 << 16, 128), (1000, 100), (1001, 100)):
        a = torch.rand(m, n, device="cuda", generator=gen) * 2 - 1
        for rpc in (8, 2048, 16384):
            if m % 8 == 0:
                e = rel(bw_probe.read_reduce(a, rpc),
                        bw_probe.read_reduce_reference(a))
                if not e <= 1e-6:
                    raise AssertionError(f"read_reduce ({m}, {n}) rows/CTA "
                                         f"{rpc}: rel err {e:.3e}")
            if not torch.equal(bw_probe.copy(a, rpc),
                               bw_probe.copy_reference(a)):
                raise AssertionError(f"copy ({m}, {n}) rows/CTA {rpc} is "
                                     "not bitwise the plain version")
    print("probes vs plain: read_reduce within 1e-6 of a float64 sum, copy "
          "bitwise, at (65536, 128), (1000, 100), (1001, 100)", flush=True)


def phase_bw_sweep() -> dict:
    """The measurement path: ``harness.bw``'s sweep at (2^22, 128)."""
    reset_counts()
    rows = bw.sweep(m=M_BW, n=N, loops=5)
    torch.cuda.synchronize()
    counts = read_counts()
    if counts["read_reduce"] < 1 or counts["copy"] < 1:
        raise AssertionError(f"bandwidth sweep launches {counts}")
    best = {k: max((r for r in rows if r["probe"].startswith(k)),
                   key=lambda r: r["gbps"]) for k in ("read_reduce", "copy")}
    print(json.dumps({"bw_path": f"harness.bw.sweep({M_BW}x{N} f32)",
                      "launches": counts,
                      "best_read": best["read_reduce"],
                      "best_copy": best["copy"],
                      "data_sheet_gbps": flops.H100_BYTES_PER_S / 1e9}),
          flush=True)
    return {"counts": counts, "rows": rows}


def phase_inplace(gen) -> dict:
    """fastqr_inplace at (2^22, 128) f32 bf16x6_cor: Q on A's storage,
    bitwise the non-aliased call's, at the mode's grade, and the call's
    peak allocation above its input under INPLACE_PEAK_MAX."""
    a0 = torch.rand(M_BW, N, device="cuda", generator=gen) * 2 - 1
    out = {}
    reset_counts()
    for method, variant in INPLACE_CASES:
        what = f"{method}/{variant}"
        if method == "cholqr1_fused":
            q0, r0 = cholqr.cholqr1_fused(a0, MODE)
        else:
            q0, r0 = cholqr._METHODS[method](a0, MODE, variant=variant)
        a = a0.clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        q, r = tsqr_tpu_torch.fastqr_inplace(a, MODE, method, variant)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        if q.data_ptr() != a.data_ptr():
            raise AssertionError(f"in-place {what}: Q is not on A's storage")
        if not (torch.equal(q, q0) and torch.equal(r, r0)):
            raise AssertionError(f"in-place {what}: not bitwise the "
                                 "non-aliased call")
        del q0, r0
        orth = validation.orthogonality_accurate(q)
        res = validation.residual_accurate(a0, q, r)
        if not (orth < 1e-5 and res < 1e-5):
            raise AssertionError(f"in-place {what}: orth {orth:.2e} "
                                 f"residual {res:.2e}")
        if not peak < INPLACE_PEAK_MAX:
            raise AssertionError(f"in-place {what}: peak {peak} B above A")
        out[what] = {"orthogonality": orth, "residual": res,
                     "peak_bytes_above_input": peak,
                     "input_bytes": a.numel() * 4}
        del a, q, r
    counts = read_counts()
    if counts["stream_gram_alias_q"] != len(INPLACE_CASES):
        raise AssertionError(f"in-place path launches {counts}")
    print(json.dumps({"inplace_path": f"fastqr_inplace({M_BW}x{N} f32, "
                                      f"{MODE})", "launches": counts,
                      "runs": out}), flush=True)
    return {"counts": counts}


def phase_cholqr2(a) -> None:
    """Every cholqr2_fused variant at the bench shape."""
    out = {}
    for variant in CHOLQR2_VARIANTS:
        reset_counts()
        q, r = tsqr_tpu_torch.fastqr(a, MODE, "cholqr2_fused", variant)
        torch.cuda.synchronize()
        launches = gs.LAUNCHES
        orth = validation.orthogonality_accurate(q)
        res = validation.residual_accurate(a, q, r)
        del q, r
        ms = timing.time_cuda(lambda v=variant: tsqr_tpu_torch.fastqr(
            a, MODE, "cholqr2_fused", v), reps=5, warmup=1)
        if not (orth < 1e-5 and res < 1e-5) or launches < 3:
            raise AssertionError(f"cholqr2_fused/{variant}: orth {orth:.2e} "
                                 f"residual {res:.2e} launches {launches}")
        out[variant] = {"ms_median": float(np.median(ms)), "ms": ms,
                        "stream_launches": launches, "orthogonality": orth,
                        "residual": res}
    print(json.dumps({"cholqr2_fused": f"({M_MAIN}x{N} f32, {MODE})",
                      "variants": out}), flush=True)


def phase_mfu() -> None:
    """``harness.mfu``'s sweep over the reference's eleven configs at
    m = 2^20, n = 128 (fused) and 512 (their non-fused siblings)."""
    rows, errors = mfu.sweep(m=M_MAIN, ns=MFU_NS)
    if errors:
        raise AssertionError(f"mfu sweep errors: {errors}")
    want = len(mfu.CONFIGS) + sum(v == "safe" for _, _, v in mfu.CONFIGS)
    flagged = [r for r in rows if r["flag"]]
    if len(rows) != want or flagged:
        raise AssertionError(f"mfu sweep: {len(rows)} rows (want {want}), "
                             f"flagged {flagged}")


def phase_qr_auto(gen) -> None:
    """qr_auto takes cholqr3 on a uniform input and BlockQR on a
    zero-column one; qr_auto_fused takes tier 1 past the kernel's range."""
    a = torch.rand(M_MAIN, N, device="cuda", generator=gen) * 2 - 1
    q, r, used = tsqr_tpu_torch.qr_auto(a, MODE)
    checks = {"uniform": (used, validation.orthogonality_accurate(q),
                          validation.residual_accurate(a, q, r))}
    del a, q, r
    a = torch.rand(M_TIERS, N, device="cuda", generator=gen) * 2 - 1
    a[:, ZERO_COL] = 0.0
    q, r, used = tsqr_tpu_torch.qr_auto(a, MODE)
    checks["zero_column"] = (used, validation.orthogonality_accurate(q),
                             validation.residual_accurate(a, q, r))
    del a, q, r
    a = torch.rand(M_WIDE, N_WIDE, device="cuda", generator=gen) * 2 - 1
    reset_counts()
    q, r, info = tsqr_tpu_torch.qr_auto_fused(a, MODE, return_info=True)
    checks["fused_wide"] = (info["tier"], validation.orthogonality_accurate(q),
                            validation.residual_accurate(a, q, r))
    counts = read_counts()
    del a, q, r
    want = {"uniform": "cholqr3", "zero_column": "blockqr_tsqr",
            "fused_wide": 1}
    print(json.dumps({"qr_auto": {
        k: {"used": u, "orthogonality": o, "residual": e}
        for k, (u, o, e) in checks.items()},
        "fused_wide_launches": counts}), flush=True)
    for k, (u, o, e) in checks.items():
        if u != want[k] or not (o < 1e-5 and e < 1e-5):
            raise AssertionError(f"qr_auto {k}: {u} (want {want[k]}), "
                                 f"orth {o:.2e} residual {e:.2e}")
    if counts["stream_gram"]:
        raise AssertionError("qr_auto_fused at n = 512 launched the stream "
                             "kernel")


def grad_of(entry: str, a, w, v, mode: str, **kw):
    """d(sum Q.W + sum R.V)/dA through ``entry``, and the (Q, R) taken."""
    a = a.detach().clone().requires_grad_()
    q, r = getattr(tsqr_tpu_torch, entry)(a, mode, **kw)
    loss = (q.float() * w).sum() + (r.float() * v).sum()
    (g,) = torch.autograd.grad(loss, a)
    return g, q, r


def phase_grad(gen) -> None:
    """Gradients through the entry points on the card: the ladder at tier
    1 (bf16x6_cor and fp32, the stream kernel), the tree and BlockQR (the
    panel kernel), at (M_GRAD, N_GRAD).  Q and R from the card carry a
    grad_fn; each gradient is held against the same entry's with
    device="cpu" on the same input; a CPU tensor given to the card's entry
    gets its gradient back on the CPU."""
    a = torch.rand(M_GRAD, N_GRAD, device="cuda", generator=gen) * 2 - 1
    w = torch.rand(M_GRAD, N_GRAD, device="cuda", generator=gen) * 2 - 1
    v = torch.rand(N_GRAD, N_GRAD, device="cuda", generator=gen) * 2 - 1
    out = {}
    reset_counts()
    for entry, mode in GRAD_CASES:
        what = f"{entry} {mode}"
        g, q, r = grad_of(entry, a, w, v, mode)
        if q.grad_fn is None or r.grad_fn is None:
            raise AssertionError(f"grad {what}: Q or R has no grad_fn")
        g_cpu, _, _ = grad_of(entry, a.cpu(), w.cpu(), v.cpu(), mode,
                              device="cpu")
        e = rel(g.cpu(), g_cpu)
        if not (bool(torch.isfinite(g).all()) and e <= GRAD_TOL):
            raise AssertionError(f"grad {what}: rel err vs the CPU {e:.3e}")
        out[what] = {"rel_err_vs_cpu": e, "ms": float(np.median(
            timing.time_cuda(lambda en=entry, md=mode: grad_of(
                en, a, w, v, md), reps=3, warmup=1)))}
    counts = read_counts()
    if counts["stream_gram"] < 1 or counts["panel_qr"] < 1:
        raise AssertionError(f"grad phase launches {counts}")
    g_moved, _, _ = grad_of("tsqr", a.cpu(), w, v, MODE)
    if g_moved.device.type != "cpu":
        raise AssertionError("a CPU input's gradient is not on the CPU")
    print(json.dumps({"grad_path": f"({M_GRAD}x{N_GRAD} f32), loss sum "
                                   "Q.W + R.V", "tolerance": GRAD_TOL,
                      "launches": counts, "cases": out}), flush=True)


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


def probe_entry(name: str, counts: dict, gen) -> dict:
    """A bandwidth probe at the sweep's shape (2^22, 128) and default rows
    per CTA: held against its plain version, timed beside it, the library
    call and the bound."""
    a = torch.rand(M_BW, N, device="cuda", generator=gen) * 2 - 1
    if name == "read_reduce":
        fn, plain = bw_probe.read_reduce, bw_probe.read_reduce_reference
        lib = (lambda: a.view(-1, 8, N).sum(0))
        replaces = "scripts/bw_experiments.py:46 (B5)"
        rpc = bw_probe.DEFAULT_ROWS_PER_CTA
    else:
        fn, plain = bw_probe.copy, bw_probe.copy_reference
        lib = (lambda: torch.mul(a, bw_probe.COPY_SCALE))
        replaces = "scripts/bw_experiments.py:74 (B6)"
        rpc = bw_probe.COPY_DEFAULT_ROWS_PER_CTA
    got, ref = fn(a), plain(a)
    torch.cuda.synchronize()
    err = float((got.double() - ref.double()).abs().max())
    if not (rel(got, ref) <= 1e-6 if name == "read_reduce"
            else torch.equal(got, ref)):
        raise AssertionError(f"{name} at ({M_BW}, {N}) disagrees with its "
                             "plain version")
    del got, ref
    bound = flops.probe_bound(M_BW, N, name)
    entry = {"name": name, "route": "cuda", "source": BW_SOURCE,
             "replaces": replaces, "launches": counts[name],
             "max_abs_err": err,
             "ms": float(np.median(timing.time_cuda(lambda: fn(a), reps=10,
                                                    warmup=1))),
             "plain_ms": float(np.median(timing.time_cuda(
                 lambda: plain(a), reps=5, warmup=1))),
             "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
             "library_ms": float(np.median(timing.time_cuda(
                 lib, reps=5, warmup=1))),
             "shapes": f"({M_BW}, {N}) f32, {rpc} rows per CTA"}
    if name == "read_reduce":
        entry["sum_stage_launches"] = counts["read_reduce_sum"]
    entry["gbps"] = bound["bytes"] / entry["ms"] / 1e6
    return entry


def phase_kernels_line(a, counts, gen, tier4: dict, bw_run: dict,
                       inplace: dict) -> None:
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
    # the Q pass written over its input (alias_q, the in-place path's call
    # kind), on a copy of A with an identity factor so that repeated calls
    # keep A's values
    a_alias, eye = a.clone(), torch.eye(N, device="cuda")
    ref = gs.stream_reference(a, (eye,), (MODE,), write_q=True)
    q_alias = gs.stream(a_alias, (eye,), (MODE,), write_q=True, alias_q=True)
    torch.cuda.synchronize()
    if (q_alias.data_ptr() != a_alias.data_ptr()
            or not rel(q_alias, ref) <= TOL[MODE]):
        raise AssertionError("alias_q at the main shape")
    alias_err = float((q_alias.double() - ref.double()).abs().max())
    del ref, q_alias
    alias_ms = float(np.median(timing.time_cuda(lambda: gs.stream(
        a_alias, (eye,), (MODE,), write_q=True, alias_q=True))))
    del a_alias
    p_ms = [float(np.median(timing.time_cuda(
        lambda c=c: gs.stream_reference(a, **c), reps=2, warmup=1)))
        for c in calls]
    lib_ms = [float(np.median(timing.time_cuda(lambda: a.T @ a))),
              float(np.median(timing.time_cuda(lambda: a @ rinv)))]
    # the other modes and the compact_final call kind, each held against
    # its plain version at the check shape and timed at the main shape
    mode_ms = {}
    delta = 1e-3 * torch.randn(N, N, device="cuda", generator=gen) / math.sqrt(N)
    kinds = {f"gram {md}": dict(gram_mode=md) for md in OTHER_MODES}
    kinds.update({f"qpass {md}": dict(rinvs=(rinv,), dot_modes=(md,),
                                      write_q=True) for md in OTHER_MODES})
    kinds["compact_final " + MODE] = call_sites(MODE, rinv, delta)[
        "compact_final"]
    for label, cfg in kinds.items():
        compare(a[:M_CHECK], cfg, TOL[label.split()[-1]], label)
        mode_ms[label] = float(np.median(timing.time_cuda(
            lambda c=cfg: gs.stream(a, **c))))
    mode_ms["gram " + MODE], mode_ms["qpass " + MODE] = k_ms
    mode_ms["qpass_alias_q " + MODE] = alias_ms
    print(json.dumps({"stream_call_kinds_ms": {
        k: {"ms": v, "before_redesign_ms": BEFORE_REDESIGN_MS.get(k)}
        for k, v in mode_ms.items()},
        "before_redesign_source": "harness/stream_calls.py, PERF.md"}),
        flush=True)
    t_bytes = sum(b["bytes"] for b in bounds) / flops.H100_BYTES_PER_S
    t_ops = sum(b["bf16_flops"] / flops.H100_BF16_FLOPS
                + b["fp32_flops"] / flops.H100_FP32_FLOPS for b in bounds)

    # the reduction stage at the main path's shape: one float64 (n, n)
    # partial per CTA pair of a Gram launch
    grid = gs.grid_size(M_MAIN, N, (), gs._kernel_code(gs._mode(MODE)))
    part = torch.randn(grid // 2, N, N, dtype=torch.float64, device="cuda",
                       generator=gen)
    red = gs.reduce_partials(part)
    red_ref = part.sum(0).float()
    red_err = float((red.double() - red_ref.double()).abs().max())
    if not rel(red, red_ref) <= 1e-6:
        raise AssertionError("reduction stage disagrees with torch.sum")
    # device time per call from a CUDA graph of 20 calls: one call's
    # event time is mostly the host's launch at this size
    r_ms = timing.graph_ms(lambda: gs.reduce_partials(part))
    r_plain = timing.graph_ms(lambda: part.sum(0).float())
    r_lib = timing.graph_ms(lambda: part.sum(0))
    r_event_ms = {"kernel": float(np.median(timing.time_cuda(
        lambda: gs.reduce_partials(part)))), "library": float(np.median(
            timing.time_cuda(lambda: part.sum(0))))}
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
         "per_call_ms": {"gram": k_ms[0], "qpass": k_ms[1],
                         "qpass_alias_q": alias_ms},
         "alias_q_launches": inplace["counts"]["stream_gram_alias_q"],
         "alias_q_max_abs_err": alias_err,
         "per_call_plain_ms": {"gram": p_ms[0], "qpass": p_ms[1]},
         "per_call_bound_ms": {"gram": bounds[0]["bound_ms"],
                               "qpass": bounds[1]["bound_ms"]},
         "per_call_library_ms": {"a.T@a": lib_ms[0], "a@rinv": lib_ms[1]},
         "per_call_kind_ms": mode_ms,
         "split_r_prologue": "each launch with dots first splits its "
                             "factors once (stream_gram_split_r_kernel)"},
        {"name": "stream_gram_reduce", "route": "cuda", "source": SOURCE,
         "replaces": "tsqr_tpu/ops/pallas_gram.py:280",
         "launches": counts["stream_gram_reduce"], "max_abs_err": red_err,
         "ms": r_ms, "plain_ms": r_plain,
         "bound_ms": 1e3 * r_bytes / flops.H100_BYTES_PER_S,
         "bound_by": "bytes", "library_ms": r_lib,
         "shapes": f"({part.shape[0]}, {N}, {N}) float64 partials",
         "timing": "CUDA graph of 20 calls (utils/timing.graph_ms)",
         "single_call_event_ms": r_event_ms},
        panel_entry(tier4),
        probe_entry("read_reduce", bw_run["counts"], gen),
        probe_entry("copy", bw_run["counts"], gen),
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
    phase_bw_vs_plain(gen)
    main_run = phase_main(gen)
    tier4 = phase_tier4(gen)
    phase_tiers(args.seed)
    phase_qr_wide(gen)
    bw_run = phase_bw_sweep()
    inplace = phase_inplace(gen)
    phase_cholqr2(main_run["a"])
    phase_mfu()
    phase_qr_auto(gen)
    phase_grad(gen)
    phase_gram_error(main_run["a"])
    phase_kernels_line(main_run["a"], main_run["counts"], gen, tier4,
                       bw_run, inplace)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
