#!/usr/bin/env python3
"""Smoke run of tsqr_tpu_torch on one NVIDIA GPU: build the stream (n <=
128 and wide), panel (n <= 128 and wide) and bandwidth-probe kernels,
hold each against its plain PyTorch
version, drive the predictive ladder at the bench shape (2^20, 128)
through tier 1 and, with a zeroed column, through tier 4 (the
Householder tree on the panel kernel), run it at tiers 2 and 3, run
BlockQR past one panel at (2^18, 512), run the stream kernel's wide
range (the ``wide`` phase: the wide kernels of ``stream_wide.cu``
against their plain versions at n = 256, 1024 and 2048, the bench's
ladder at (2^19, 512) through tier 1 on them alone, the in-place QR at
(2^19, 1024), the compact CholeskyQR3 at (2^18, 1024), ``tsqr`` at
(2^18, 256) and ``rsvd`` at rank 200), run the panel kernel's wide
range (the ``panel_wide`` phase: the wide panel kernel of
``panel_wide.cu`` against its plain version in every mode at n = 136,
256, 384 and 512, ``tsqr`` on it at (2^20, 256) and (2^19, 512) beside
the blocked-Householder leaf, the leaf heights at (2^20, 256), ``cca``
256 wide and ``qr`` with 256-wide panels), hold the Q build's
split-product kernel ``split_mm.cu`` to its plain version and to the
float64 product at the trees' largest products, under a limit that the
product a part short fails, and time it (the ``split_mm`` phase), run the
measurement path (the bandwidth sweep of ``harness.bw`` and the
``harness.mfu`` sweep), the in-place QR at (2^22, 128), every
cholqr2_fused variant and ``qr_auto``,
take gradients through the entry points on the card (the ``grad`` phase:
the ladder, the tree and BlockQR, held against the CPU's), run the five
QR updates at (2^20, 128) (the ``update`` phase), the reference's
accuracy experiments at its sizes (the ``harness`` phase) and the phase
breakdowns and ``torch.profiler`` traces of tier 4 and BlockQR (the
``profile`` phase), run the beyond-memory QR (the ``ooc`` phase: the
matrix-free ``qr_regen`` and ``lstsq_regen`` at (2^26, 128), the
host-streamed ``qr_out_of_core`` at (2^25, 128), and a checkpointed run
killed in a child process and resumed bitwise), every model of
``models/`` at the width its users run (the ``models`` phase), the
distributed layer (the ``distributed`` phase: four ranks on the card
over gloo, each holding (2^20, 128) of a global (2^22, 128), every
driver of ``parallel/dtsqr.py``, the models' ``mesh=`` routes and three
drivers' gradients, each held to the single-card result of the same
global input, then a one-rank NCCL group) and the native emulation
cores against the card's emulation products (the ``native`` phase),
run ``bench_torch.py``'s headline rung in a child process as its users
run it (the ``bench`` phase, right after the main path), time the stream
kernel's call kinds beside those of the kernel before its redesign, and
print the ``kernels`` JSON line and a last JSON line with the device.

    python3 chip_smoke.py [--seed N]

Run it from the root of a checkout.  Every phase passes or raises; any
failure exits non-zero before the last line is printed.
"""

from __future__ import annotations

import argparse
import collections
import importlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import tsqr_tpu_torch  # noqa: E402
from tsqr_tpu_torch.harness import bw, flops, mfu  # noqa: E402
from tsqr_tpu_torch.harness import accuracy, cond, eval_q  # noqa: E402
from tsqr_tpu_torch.harness import compare as compare_mod  # noqa: E402
from tsqr_tpu_torch.harness import main as harness_main  # noqa: E402
from tsqr_tpu_torch.harness import bench, profile  # noqa: E402
from tsqr_tpu_torch.core import auto, cholqr, ooc, update  # noqa: E402
from tsqr_tpu_torch import modes  # noqa: E402
from tsqr_tpu_torch.utils import experimental  # noqa: E402
from tsqr_tpu_torch.core import tsqr as tsqr_mod  # noqa: E402
from tsqr_tpu_torch.ops import _build, bw_probe, gram_stream as gs  # noqa: E402
from tsqr_tpu_torch.ops import householder  # noqa: E402
from tsqr_tpu_torch.ops import panel_kernel as pk  # noqa: E402
from tsqr_tpu_torch.ops import split_mm as sm  # noqa: E402
from tsqr_tpu_torch.utils import latms, timing, validation  # noqa: E402
from tsqr_tpu_torch.utils import native, trace  # noqa: E402
from tsqr_tpu_torch import models as tmodels  # noqa: E402
from tsqr_tpu_torch.harness import dist as dist_h  # noqa: E402
from tsqr_tpu_torch.parallel import launch  # noqa: E402

N = 128
M_MAIN = 1 << 20
M_CHECK = 1 << 16
M_TIERS = 1 << 18
MODE = "bf16x6_cor"
SOURCE = "tsqr_tpu_torch/ops/csrc/stream_gram.cu"
PANEL_SOURCE = "tsqr_tpu_torch/ops/csrc/panel_qr.cu"
BW_SOURCE = "tsqr_tpu_torch/ops/csrc/bw_probe.cu"
WIDE_SOURCE = "tsqr_tpu_torch/ops/csrc/stream_wide.cu"
WIDE_PANEL_SOURCE = "tsqr_tpu_torch/ops/csrc/panel_wide.cu"
SPLIT_MM_SOURCE = "tsqr_tpu_torch/ops/csrc/split_mm.cu"
KERNELS = ("stream_gram", "stream_wide", "panel_qr", "panel_wide",
           "bw_probe", "split_mm")
M_BW = 1 << 22       # the bandwidth sweep's and the in-place runs' rows
INPLACE_PEAK_MAX = 64 << 20  # bytes a call may allocate above its input
INPLACE_CASES = (("cholqr1_fused", "safe"), ("cholqr2_fused", "compact"),
                 ("cholqr2_fused", "turbo"), ("cholqr3_fused", "compact"))
CHOLQR2_VARIANTS = ("safe", "fast", "fastest", "compact", "turbo")
MFU_NS = (128, 256, 512, 1024, 2048)
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
# the wide phase: the wide stream kernels (128 < n <= 2048, every mode)
# against their plain versions at these shapes and modes (each call kind
# of the ladder, so the bf16x3_cor corrections at n = 2048 too); at
# n = 1024 the plain version's float32 products (another summation order
# over n terms) and the kernel's sit ~1e-6 apart, twice the n <= 128
# tolerance
WIDE_CHECKS = (((1 << 16, 256), "bf16x6_cor"), ((1 << 15, 1024), "bf16x6_cor"),
               ((1 << 14, 2048), "fp32"), ((1 << 14, 2048), "bf16"),
               ((1 << 14, 2048), "bf16x6_cor"))
WIDE_TOL = {"fp32": 2e-6, "bf16x6_cor": 2e-6, "bf16x3_cor": 1e-5,
            "bf16": 4e-3}
M_WIDE_LADDER = 1 << 19          # the wide path: the bench's ladder at n = 512
M_WIDE_INPLACE, N_WIDE_INPLACE = 1 << 19, 1024
INPLACE_WIDE_PEAK_MAX = 1 / 8    # of A's bytes, above A
M_WIDE_CQR3, N_WIDE_CQR3 = 1 << 18, 1024
# the fp32 pipelines past 1024 (their bf16x3_cor corrections included)
M_WIDE_FP32, N_WIDE_FP32 = 1 << 16, 2048
M_WIDE_TSQR, N_WIDE_TSQR = 1 << 18, 256
M_RSVD, N_RSVD, RANK_RSVD = 1 << 16, 512, 200
RSVD_TOL = 1e-4      # a rank-200 input recovered at rank 200 (+8)
# panel kernel against its plain version: the two sum in other orders
# (warp reductions against batched matmuls), which moves Q and R of a
# well-conditioned tile by a few ulps of the mode times sqrt(L); each
# tile's orthogonality and residual are held to the mode's grade
# (core/auto.py _TOL)
PANEL_TOL = {"fp32": 1e-5, "bf16x6_cor": 1e-5, "bf16x3_cor": 1e-4}
PANEL_CASES = ((264, 256, 128), (64, 256, 64), (33, 200, 50))
# a tree level's batches of (256, 128) nodes on the cluster path
PANEL_LEVEL_BATCHES = (64, 16, 1)
# the panel_wide phase: the wide panel kernel (128 < n <= 512) against its
# plain version in every mode at these widths (the last 64-column panel 8
# wide at 136 and 200), L in {n, 2n, L_WIDE_MAX}, each case its own
# seeded inputs, with a zero column and zero rows, to
# tests/test_torch_gpu.py's PANEL_MODES, both factors in canonical signs
# (``canonical``); the one-part bf16 modes (ONE_PART) hold R, the
# orthogonality and the residual to their grade but not Q^T to the plain
# version's: at one part a changed float32 sum rounds a later split
# differently, and a square tile's last columns of Q follow that order;
# then tsqr on the wide leaf at full width (1 GiB of A each), cca 256 wide
# and BlockQR with 256-wide panels
WIDE_PANEL_NS = (136, 200, 256, 384, 512)
WIDE_PANEL_TOL = {"fp32": 1e-5, "bf16x6_cor": 1e-5, "bf16x3_cor": 1e-4,
                  "bf16x3_nocor": 1e-4, "bf16": 5e-2, "bf16_nocor": 5e-2}
ONE_PART = ("bf16", "bf16_nocor")
WIDE_PANEL_PATHS = ((1 << 20, 256), (1 << 19, 512))
# leaf heights at (2^20, 256) beside the default's (fanin 8: L = 256 for
# every target from 2n to L_WIDE_MAX): (leaf_rows, fanin)
WIDE_PANEL_HEIGHTS = ((1024, 4), (512, 2))
M_CCA_WIDE, P_CCA_WIDE, Q_CCA_WIDE = 1 << 18, 256, 64
# the split_mm phase: the Q build's kernel against its plain version and
# the float64 product at the trees' largest products, (batch, M, K, N):
# tall256's layer-0 and first-level products and tall128.rankdef's
# layer-0 product, x the transposed view of Q^T as the tree passes it;
# every part count, then timed at bf16x6_cor beside the plain version
SPLIT_MM_SHAPES = ((4096, 256, 256, 256), (1024, 1024, 256, 256),
                   (4096, 256, 128, 128))
SPLIT_MM_MODES = {1: "bf16", 2: "bf16x3_cor", 3: MODE}
M_QR_PANEL, N_QR_PANEL, QR_PANEL_WIDTH = 1 << 18, 512, 256
# the grad phase: (m, n), and the cases (entry, mode).  The card's and the
# CPU's factors agree to float32 grade; the rule carries their difference
# through R^{-1}, kappa(A) ~ 5 for these uniform inputs
M_GRAD, N_GRAD = 1 << 14, 64
GRAD_CASES = (("qr_auto_fused", "bf16x6_cor"), ("qr_auto_fused", "fp32"),
              ("tsqr", "bf16x6_cor"), ("qr", "bf16x6_cor"))
GRAD_TOL = 1e-5
# the update phase: the bench's input, its updates, and the CPU check's rows
UPDATES = ("append_rows", "append_cols", "delete_cols", "delete_rows",
           "rank_update")
UPDATE_MODES = ("bf16x6_cor", "fp32")
P_ROWS, P_COLS, DROP_COLS, RANK = 1 << 14, 16, (0, 63, 127), 8
M_UPDATE_CPU = 4096
UPDATE_TOL = 1e-5    # orthogonality and residual of every updated factor
# the harness phase: the reference's cond grid (m = 2^15, n = 2^7,
# kappa = 2^2 .. 2^15) and the full accuracy grid's widest corner
M_REF, N_REF_WIDE = 1 << 15, 1024
CORRECTED_ORTH_MAX = 1e-5   # what bf16x6_cor promises
# the ooc phase: the reference sweep's top row, m = 2^26 at n = 128, made
# on the card by a generator (data/bigm2.csv's regen rows); the
# host-streamed QR at 2^25 (16 GiB of A and of Q in host memory); the
# resume across a process's death at 2^22
M_REGEN, REGEN_CHUNK, REGEN_SEED = 1 << 26, 1 << 21, 7
REGEN_CASES = (("bf16", "cholqr1"), ("bf16x6_cor", "cholqr2"))
# the JAX package's data/bigm2.csv rows at (2^26, 128), for grade only
JAX_BIGM2 = {"bf16": (2.657e-3, 2.551e-3), "bf16x6_cor": (4.415e-5, 1.106e-7)}
REGEN_ORTH_MAX = 3 * JAX_BIGM2["bf16x6_cor"][0]
M_REGEN_Q = 1 << 22
M_OOC, OOC_CHUNK = 1 << 25, 1 << 20
M_RESUME, RESUME_CHUNK, RESUME_FAULT = 1 << 22, 1 << 19, 12
RESUME_EXIT = 17     # the child's exit code after its injected fault
# the models phase: each entry at the width its users run
# (harness/dist.py's model_runs), graded in float64
MODEL_TOL = 1e-5
# the distributed phase: DIST_WORLD ranks on the card, each holding
# (2^20, 128) of a global (2^22, 128) (harness/dist.py)
DIST_WORLD = dist_h.WORLD
DIST_TOL = 1e-5      # global orthogonality and residual of every driver
DIST_TIMEOUT = 600   # seconds a spawned group may take
BENCH_SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "bench_torch.py")
BENCH_TIMEOUT = 300  # seconds the bench's headline rung may take
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline"}  # bench.py's
# mesh route against single card, where 1e-5 is not the grade: lstsq's
# x carries kappa = 1e2 times the factorization's error (as the models
# phase's gate), Nystrom's lam the float32 whitening's error (ditto)
MODEL_DIST_TOL = {"lstsq ridge=0.0": 1e2 * MODEL_TOL,
                  "lstsq ridge=0.01": 1e2 * MODEL_TOL, "nystrom": 5e-2}


def rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    x, ref = x.double(), ref.double()
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


_COUNTED = collections.Counter()   # the launch counters at reset_counts


def reset_counts() -> None:
    global _COUNTED
    _COUNTED = trace.counts("launches.")


def read_counts() -> collections.Counter:
    """{kernel: launches} since :func:`reset_counts` (0 for a kernel not
    launched)."""
    return trace.counts("launches.") - _COUNTED


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
    """Every kernel source, one nvcc each, started together; each kernel's
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
    return {"a": a, "counts": counts, "ladder_ms_median": ladder_ms,
            "useful_tflops": useful / ladder_ms / 1e9}


def phase_bench(main_run: dict) -> dict:
    """``bench_torch.py --single`` at the headline rung, in a child
    process, as its users run it: its last stdout line must carry
    bench.py's four keys and a value above 0 (the orthogonality gate
    passed), its stderr record tier 1.  Printed beside the main path's
    reading of the same ladder; the two are not compared."""
    t0 = time.perf_counter()
    m, k = bench.HEADLINE
    child = subprocess.run(
        [sys.executable, BENCH_SCRIPT, "--single", str(m), str(k)],
        capture_output=True, text=True, timeout=BENCH_TIMEOUT)
    sys.stderr.write(child.stderr)
    lines = child.stdout.strip().splitlines()
    if child.returncode != 0 or not lines:
        raise AssertionError(f"bench_torch.py exited {child.returncode}")
    result = json.loads(lines[-1])
    if (set(result) != BENCH_KEYS or result["metric"] != bench.METRIC
            or result["unit"] != "TFLOP/s" or not result["value"] > 0):
        raise AssertionError(f"bench_torch.py printed {result}")
    records = [json.loads(ln.split("record ", 1)[1])
               for ln in child.stderr.splitlines()
               if ln.startswith("bench: record ")]
    if not records or records[-1]["tier"] != 1:
        raise AssertionError(f"bench_torch.py's record: {records}")
    print(json.dumps({
        "bench": result, "record": records[-1],
        "main_path_ladder_ms_median": main_run["ladder_ms_median"],
        "main_path_useful_tflops": main_run["useful_tflops"],
        "seconds": time.perf_counter() - t0}), flush=True)
    return records[-1]


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


def canonical(qt, r):
    """Q^T and R with diag(R) >= 0: each row of R and of Q^T times the
    sign of its diagonal entry (+1 for a zero)."""
    s = torch.where(torch.diagonal(r, dim1=-2, dim2=-1) < 0, -1.0, 1.0)
    return qt * s[..., :, None], r * s[..., :, None]


def compare_panel(a, mode, what, tols=PANEL_TOL, signs=False) -> float:
    """Panel kernel against its plain version on the same tiles; returns
    the max abs error over Q^T and R.  With ``signs``, both in canonical
    form (``canonical``): a pivot within the mode's rounding of 0 takes
    either sign in two summation orders, each the convention's, and
    flips its column of Q and row of R.  A ``ONE_PART`` mode holds R to
    the plain version's and Q by its orthogonality and the residual."""
    qt, r = pk.panel_qr_batched(a, mode)
    qt0, r0 = pk.panel_qr_reference(a, mode)
    torch.cuda.synchronize()
    if signs:
        (qt, r), (qt0, r0) = canonical(qt, r), canonical(qt0, r0)
    tol = tols[mode]
    pairs = (("R", r, r0),) + (() if mode in ONE_PART
                               else (("Q^T", qt, qt0),))
    for name, x, y in pairs:
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


def wide_panel_checks() -> dict:
    """The wide panel kernel against its plain version: every mode, n in
    WIDE_PANEL_NS, L in {n, 2n, L_WIDE_MAX}, three tiles with a zero
    column (R_jj = 0) and, where L > n, seven zero rows below every pivot
    (exactly zero Q rows), drawn from a generator of the case's own, so
    that another width leaves the other cases' inputs as they were; the
    max abs error per mode."""
    errs = {md: 0.0 for md in WIDE_PANEL_TOL}
    for n in WIDE_PANEL_NS:
        for L in sorted({n, min(2 * n, pk.L_WIDE_MAX), pk.L_WIDE_MAX}):
            gen = torch.Generator(device="cuda").manual_seed((n << 16) + L)
            a = torch.rand(3, L, n, device="cuda", generator=gen) * 2 - 1
            a[:, :, n // 3] = 0.0
            z = L - 7 if L - 7 >= n else L
            a[:, z:, :] = 0.0
            for mode in WIDE_PANEL_TOL:
                what = f"panel_wide (3, {L}, {n}) {mode}"
                launches = trace.counts("launches.")["panel_qr_wide"]
                outer = trace.counts("panel_wide.")["outer_applies"]
                errs[mode] = max(errs[mode], compare_panel(
                    a, mode, what, WIDE_PANEL_TOL, signs=True))
                qt, r = pk.panel_qr_batched(a, mode)
                torch.cuda.synchronize()
                if (trace.counts("launches.")["panel_qr_wide"]
                        != launches + 2
                        or trace.counts("panel_wide.")["outer_applies"]
                        != outer + 2 * pk.wide_outer_applies(n)):
                    raise AssertionError(f"{what}: the wide kernel did not "
                                         "launch its sequence")
                if not (bool((qt[:, :, z:] == 0).all())
                        and bool((r[:, n // 3, n // 3] == 0).all())):
                    raise AssertionError(f"{what}: zero rows or the zero "
                                         "column")
    return errs


def inner_levels(bs: int, fanin: int) -> int:
    """Batched QRs of the tree above its leaves."""
    levels = 0
    while bs > 1:
        bs //= min(fanin, bs)
        levels += 1
    return levels


def tree_launches(m: int, n: int) -> tuple[int, int, int]:
    """(leaves, leaf rows, inner levels) of the default tree at (m, n)."""
    fanin = tsqr_mod.DEFAULT_FANIN
    bs, L, _ = tsqr_mod.tree_plan(m, n, tsqr_mod.default_leaf_rows(n),
                                  fanin)
    return bs, L, inner_levels(bs, tsqr_mod.inner_route(None, n, fanin)[1])


def wide_panel_path(m: int, n: int, gen) -> dict:
    """tsqr at (m, n) f32 MODE on the wide kernel: held to < 1e-5, one
    wide-kernel call for the leaves and one a level of inner nodes, and
    no blocked-Householder call (recorded by shape); timed beside the
    same call with the blocked-Householder leaf (impl="jnp", the route
    before the port)."""
    a = torch.rand(m, n, device="cuda", generator=gen) * 2 - 1
    fanin = tsqr_mod.DEFAULT_FANIN
    bs, L, levels = tree_launches(m, n)
    hh = []
    plain_hh = householder.blocked_householder_qr
    householder.blocked_householder_qr = (
        lambda x, *args, **kw: hh.append(tuple(x.shape))
        or plain_hh(x, *args, **kw))
    try:
        torch.cuda.synchronize()
        reset_counts()
        inner = trace.counts("tsqr.inner.")
        outer = trace.counts("panel_wide.")["outer_applies"]
        q, r = tsqr_tpu_torch.tsqr(a, MODE)
        torch.cuda.synchronize()
        counts = read_counts()
        inner = trace.counts("tsqr.inner.") - inner
        outer = trace.counts("panel_wide.")["outer_applies"] - outer
    finally:
        householder.blocked_householder_qr = plain_hh
    orth = validation.orthogonality_accurate(q)
    res = validation.residual_accurate(a, q, r)
    del q, r
    if not (orth < 1e-5 and res < 1e-5
            and counts["panel_qr_wide"] == 1 + levels
            and outer == (1 + levels) * pk.wide_outer_applies(n)
            and not counts["panel_qr"] and not hh
            and inner == {"kernel": levels}
            and counts["split_mm"] == levels):
        raise AssertionError(f"tsqr ({m}, {n}) on the wide leaf: orth "
                             f"{orth:.2e} residual {res:.2e} launches "
                             f"{counts} 64-column applies {outer} inner "
                             f"levels {inner} Householder calls {hh}")
    # the gated call warmed the path; the eager leaf's call takes seconds
    ms = timing.time_cuda(lambda: tsqr_tpu_torch.tsqr(a, MODE), reps=2,
                          warmup=0)
    jnp_ms = timing.time_cuda(lambda: tsqr_tpu_torch.tsqr(a, MODE,
                                                          impl="jnp"),
                              reps=1, warmup=0)
    out = {"shape": [m, n], "leaves": [bs, L, n], "fanin": fanin,
           "inner_fanin": tsqr_mod.inner_route(None, n, fanin)[1],
           "inner_levels": levels,
           "orthogonality": orth, "residual": res,
           "launches": kernel_launches(counts), "outer_applies": outer,
           "householder_calls": [list(s) for s in hh],
           "ms_median": float(np.median(ms)), "ms": ms,
           "jnp_leaf_ms_median": float(np.median(jnp_ms)),
           "jnp_leaf_ms": jnp_ms, "counts": counts}
    if (m, n) == WIDE_PANEL_PATHS[0]:
        out["a"] = a
    return out


def wide_panel_entry(path: dict) -> dict:
    """The wide panel kernel at the (2^20, 256) path's leaves: held to its
    plain version, timed beside it, batched torch.linalg.qr and the
    bound."""
    bs, L, n = path["leaves"]
    leaves = path["a"].reshape(bs, L, n)
    err = compare_panel(leaves, MODE, f"panel_wide main-shape ({bs}, {L}, "
                        f"{n})", WIDE_PANEL_TOL, signs=True)
    k_ms = float(np.median(timing.time_cuda(
        lambda: pk.panel_qr_batched(leaves, MODE), reps=5, warmup=1)))
    mode_ms = {md: float(np.median(timing.time_cuda(
        lambda md=md: pk.panel_qr_batched(leaves, md), reps=3, warmup=1)))
        for md in WIDE_PANEL_TOL if md != MODE}
    p_ms = float(np.median(timing.time_cuda(
        lambda: pk.panel_qr_reference(leaves, MODE), reps=2, warmup=1)))
    lib_ms = float(np.median(timing.time_cuda(
        lambda: torch.linalg.qr(leaves), reps=3, warmup=1)))
    bound = flops.panel_bound(bs, L, n, MODE)
    return {"name": "panel_qr_wide", "route": "cuda",
            "source": WIDE_PANEL_SOURCE,
            "replaces": "tsqr_tpu/ops/pallas_panel_sb.py:149 (B2 wide, "
                        "128 < n <= 512; pallas_call at :169); also "
                        "tsqr_tpu/ops/pallas_panel.py:129 (B3) there",
            "launches": path["counts"]["panel_qr_wide"],
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "library_ms": lib_ms,
            "shapes": f"({bs}, {L}, {n}) f32 {MODE} leaves of tsqr at "
                      f"({WIDE_PANEL_PATHS[0][0]}, {n}); a launch is one "
                      f"call of {pk.wide_kernel_launches(n)} kernel "
                      "launches; outer_applies is the counter "
                      "panel_wide.outer_applies over that tsqr call, as "
                      "the kernel reported its 64-column applies; "
                      "library_ms is batched torch.linalg.qr",
            "kernel_launches_a_call": pk.wide_kernel_launches(n),
            "outer_applies": path["outer_applies"],
            "other_modes_ms": mode_ms}


def phase_panel_wide(gen) -> dict:
    """The wide panel kernel (B2 wide, 128 < n <= 512): its checks
    against the plain version, then tsqr on it at (2^20, 256) and
    (2^19, 512), the leaf heights at (2^20, 256), cca 256 wide and qr
    with 256-wide panels at (2^18, 512), each gated and counted, and the
    kernel's ``kernels`` entry at the (2^20, 256) leaves."""
    t0 = time.perf_counter()
    errs = wide_panel_checks()
    t_checks = time.perf_counter() - t0
    paths = [wide_panel_path(m, n, gen) for m, n in WIDE_PANEL_PATHS]
    main = paths[0]
    a = main.pop("a")
    heights = {f"L={main['leaves'][1]} fanin={main['fanin']}": {
        "leaf_rows": None, "leaves": main["leaves"],
        "ms_median": main["ms_median"], "ms": main["ms"]}}
    for leaf_rows, fanin in WIDE_PANEL_HEIGHTS:
        bs, L, _ = tsqr_mod.tree_plan(a.shape[0], a.shape[1], leaf_rows,
                                      fanin)
        ms = timing.time_cuda(lambda: tsqr_tpu_torch.tsqr(
            a, MODE, leaf_rows=leaf_rows, fanin=fanin), reps=1, warmup=0)
        heights[f"L={L} fanin={fanin}"] = {
            "leaf_rows": leaf_rows, "leaves": [bs, L, a.shape[1]],
            "ms_median": float(np.median(ms)), "ms": ms}
    main["a"] = a
    entry = wide_panel_entry(main)
    del a, main["a"]
    consumers = {}
    g = torch.Generator(device="cuda").manual_seed(7)
    z = torch.randn(M_CCA_WIDE, 2, device="cuda", generator=g)
    x = torch.cat([z + 0.05 * torch.randn(M_CCA_WIDE, 2, device="cuda",
                                          generator=g),
                   torch.randn(M_CCA_WIDE, P_CCA_WIDE - 2, device="cuda",
                               generator=g)], 1)
    y = torch.cat([z + 0.05 * torch.randn(M_CCA_WIDE, 2, device="cuda",
                                          generator=g),
                   torch.randn(M_CCA_WIDE, Q_CCA_WIDE - 2, device="cuda",
                               generator=g)], 1)
    (c, _, _), counts, ms = timed(lambda: tmodels.cca(x, y, mode=MODE),
                                  reps=2)
    consumers["cca"] = {"shape": [M_CCA_WIDE, P_CCA_WIDE, Q_CCA_WIDE],
                        "top2": c[:2].tolist(),
                        "rest_max": float(c[2:].max()),
                        "ms": ms, "launches": kernel_launches(counts)}
    del x, y, z, c
    a = torch.rand(M_QR_PANEL, N_QR_PANEL, device="cuda",
                   generator=gen) * 2 - 1
    (q, r), counts, ms = timed(lambda: tsqr_tpu_torch.qr(
        a, MODE, panel_width=QR_PANEL_WIDTH), reps=2)
    consumers["qr"] = {"shape": [M_QR_PANEL, N_QR_PANEL],
                       "panel_width": QR_PANEL_WIDTH,
                       "orthogonality":
                           validation.orthogonality_accurate(q),
                       "residual": validation.residual_accurate(a, q, r),
                       "ms": ms, "launches": kernel_launches(counts)}
    del a, q, r
    print(json.dumps({"panel_wide": {
        "checks": {"ns": WIDE_PANEL_NS, "modes": list(WIDE_PANEL_TOL),
                   "tol": WIDE_PANEL_TOL, "max_abs_err": errs,
                   "seconds": t_checks},
        "paths": [{k: v for k, v in p.items() if k != "counts"}
                  for p in paths],
        "heights": heights, "consumers": consumers,
        "kernel": {k: entry[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "library_ms", "other_modes_ms")},
        "seconds": time.perf_counter() - t0}}), flush=True)
    cca, qr = consumers["cca"], consumers["qr"]
    if not (min(cca["top2"]) > 0.99 and cca["rest_max"] < 0.2
            and cca["launches"]["panel_qr_wide"] >= 1):
        raise AssertionError(f"panel_wide cca: {cca}")
    if not (qr["orthogonality"] < 1e-5 and qr["residual"] < 1e-5
            and qr["launches"]["panel_qr_wide"] >= 1):
        raise AssertionError(f"panel_wide qr: {qr}")
    return {"paths": {f"panel_wide {m}x{n}": p["counts"]
                      for (m, n), p in zip(WIDE_PANEL_PATHS, paths)},
            "entry": entry}


def split_operands(shape, gen):
    """x (B, M, K) as the transposed view of a (B, K, M) tensor and
    c (B, K, N), uniform in [-1, 1)."""
    B, M, K, N = shape
    x = torch.rand(B, K, M, device="cuda", generator=gen) * 2 - 1
    c = torch.rand(B, K, N, device="cuda", generator=gen) * 2 - 1
    return x.transpose(1, 2), c


def split_mm_ratio(y, y0, x, c) -> float:
    """max |y - y0| over 4 K u (|x| @ |c|): the kernel and its plain
    version sum the same exact products of bf16 parts in other orders,
    each within K u sum |x c| of the exact sum (2 u a term for the tensor
    core's truncating adds).  At most 1 passes."""
    bound = 4 * x.shape[2] * 2.0 ** -24 * (x.double().abs()
                                          @ c.double().abs())
    return float(((y.double() - y0.double()).abs() / bound).max())


def phase_split_mm(gen) -> dict:
    """The Q build's kernel (split_mm.cu) at SPLIT_MM_SHAPES: one launch a
    call, each part count held to its plain version (the mode's own
    product) and, against the float64 product, under
    ``split_mm.ERROR_LIMIT``, which the product a part short
    (``split_mm_control``) has to exceed, then timed at bf16x6_cor beside
    the plain version (``modes.mm_bf16x6_cor``, the route it replaced),
    float32 ``torch.bmm`` and the bound."""
    t0 = time.perf_counter()
    errors, times = {}, {}
    for shape in SPLIT_MM_SHAPES:
        x, c = split_operands(shape, gen)
        key = "x".join(map(str, shape))
        parts_ms = {}
        for parts, mode in SPLIT_MM_MODES.items():
            reset_counts()
            y = sm.batched_split_mm(x, c, parts)
            torch.cuda.synchronize()
            launched = read_counts()["split_mm"]
            ratio = split_mm_ratio(y, sm.split_mm_reference(x, c, parts),
                                   x, c)
            error = sm.split_mm_error(y, x, c)
            del y
            short = sm.split_mm_error(sm.split_mm_control(x, c, parts), x, c)
            limit = sm.ERROR_LIMIT[parts]
            if launched != 1 or not ratio <= 1.0 or not error <= limit < short:
                raise AssertionError(f"split_mm {key} {mode}: {launched} "
                                     f"launches, {ratio:.3f} of the plain "
                                     f"version's bound, error {error:.3e}, "
                                     f"limit {limit:.1e}, a part short "
                                     f"{short:.3e}")
            errors[f"{key} {mode}"] = {"of_plain_bound": ratio,
                                       "error": error, "limit": limit,
                                       "part_short": short}
            parts_ms[mode] = float(np.median(timing.time_cuda(
                lambda p=parts: sm.batched_split_mm(x, c, p), reps=5,
                warmup=1)))
        bound = flops.split_mm_bound(*shape, MODE)
        times[key] = {
            "ms": parts_ms[MODE], "modes_ms": parts_ms,
            "plain_ms": float(np.median(timing.time_cuda(
                lambda: modes.mm_bf16x6_cor(x, c), reps=3, warmup=1))),
            "library_ms": float(np.median(timing.time_cuda(
                lambda: torch.bmm(x, c), reps=3, warmup=1))),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "bf16_tflops": bound["bf16_flops"] / parts_ms[MODE] / 1e9}
        del x, c
    out = {"errors": errors, "times": times,
           "seconds": time.perf_counter() - t0}
    print(json.dumps({"split_mm": out}), flush=True)
    return out


def split_mm_entry(run: dict, tier4: dict, paths: dict) -> dict:
    """split_mm.cu's ``kernels`` entry: timed at tall256's layer-0
    product, its launches on every path (a list a rank on the distributed
    path)."""
    key = "x".join(map(str, SPLIT_MM_SHAPES[0]))
    t = run["times"][key]
    by_path = {p: ([r.get("split_mm", 0) for r in c] if isinstance(c, list)
                   else c.get("split_mm", 0)) for p, c in paths.items()}
    by_path["tier4"] = tier4["counts"]["split_mm"]
    return {"name": "split_mm", "route": "cuda", "source": SPLIT_MM_SOURCE,
            "replaces": "no TPU kernel: the JAX package leaves the tree's "
                        "Q-build products to XLA's matmul "
                        "(tsqr_tpu/core/tsqr.py's backward)",
            "launches": by_path[f"panel_wide {WIDE_PANEL_PATHS[0][0]}x"
                                f"{WIDE_PANEL_PATHS[0][1]}"],
            "max_error_of_bound": max(e["of_plain_bound"]
                                      for e in run["errors"].values()),
            "max_error_of_limit": max(e["error"] / e["limit"]
                                      for e in run["errors"].values()),
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")},
            "shapes": f"({key}) (batch, M, K, N) f32 {MODE}, the layer-0 "
                      "product of tsqr at (2^20, 256); plain_ms is "
                      "modes.mm_bf16x6_cor, library_ms float32 torch.bmm; "
                      "launches from the tsqr path at that shape",
            "at_shapes": run["times"], "launches_by_path": by_path}


def phase_tier4(gen) -> dict:
    """The ladder on the bench shape with one zeroed column: tiers 0-3
    fail their gates and tier 4 runs BlockQR (CGS2, one panel) over two
    Householder trees, their leaves and inner nodes on the panel kernel:
    one launch for the leaves and one a level, each tree."""
    a = torch.rand(M_MAIN, N, device="cuda", generator=gen) * 2 - 1
    a[:, ZERO_COL] = 0.0
    bs, L, levels = tree_launches(M_MAIN, N)
    fanin = tsqr_mod.inner_route(None, N, tsqr_mod.DEFAULT_FANIN)[1]
    code = gs._kernel_code(gs._mode(MODE))
    # the levels whose batch of (fanin N, N) nodes fits one wave of
    # clusters (panel_kernel.cluster_size), two trees
    on_clusters = 2 * sum(pk._launch_cluster_size(bs // fanin ** i,
                                                  fanin * N, N, code) > 1
                          for i in range(1, levels + 1))
    torch.cuda.synchronize()
    reset_counts()
    inner = trace.counts("tsqr.inner.")
    clusters = trace.counts("panel_qr.")["cluster_launches"]
    q, r, info = tsqr_tpu_torch.qr_auto_fused(a, MODE, return_info=True)
    torch.cuda.synchronize()
    counts = read_counts()
    inner = trace.counts("tsqr.inner.") - inner
    clusters = trace.counts("panel_qr.")["cluster_launches"] - clusters
    orth = validation.orthogonality_accurate(q)
    res = validation.residual_accurate(a, q, r)
    if info["tier"] != 4:
        raise AssertionError(f"tier-4 path took tier {info['tier']}")
    if not (orth < 1e-5 and res < 1e-5):
        raise AssertionError(f"tier-4 path orth {orth:.2e} residual "
                             f"{res:.2e}")
    if (counts["panel_qr"] != 2 * (1 + levels) or counts["stream_gram"] < 1
            or inner != {"kernel": 2 * levels}
            or counts["split_mm"] != 2 * levels
            or not 1 <= clusters == on_clusters):
        raise AssertionError(f"tier-4 path launches {counts}, inner levels "
                             f"{inner}, on clusters {clusters} (expected "
                             f"{on_clusters})")
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
    print(json.dumps({
        "tier4_path": f"qr_auto_fused({M_MAIN}x{N} f32, column {ZERO_COL} "
                      f"zeroed, {MODE})",
        "tier": info["tier"], "orthogonality": orth, "residual": res,
        "launches": counts, "panel_qr_cluster_launches": clusters,
        "leaves": [bs, L, N],
        "fanin": tsqr_mod.DEFAULT_FANIN, "inner_levels": levels,
        "inner_fanin": tsqr_mod.inner_route(None, N,
                                            tsqr_mod.DEFAULT_FANIN)[1],
        "ladder_ms_median": float(np.median(ladder)), "ladder_ms": ladder,
        "blockqr_reorth_ms": blockqr_ms, "one_tree_ms": tree_ms,
        "one_tree_r_only_ms": tree_r_ms,
        "torch_linalg_qr_ms": qr_ms}), flush=True)
    return {"a": a, "counts": counts, "leaves": (bs, L),
            "cluster_launches": clusters}


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
    bs, L, m_pad = tsqr_mod.tree_plan(M_WIDE, N, pk.max_leaf_rows(N),
                                      tsqr_mod.DEFAULT_FANIN)
    print(json.dumps({"qr_path": f"qr({M_WIDE}x{N_WIDE} f32, fp32, "
                                 "reorth=True)",
                      "orthogonality": orth, "residual": res,
                      "launches": counts, "leaves_per_tree": [bs, L, N],
                      "padded_rows": m_pad - M_WIDE,
                      "ms_median": float(np.median(ms)),
                      "ms": ms, "torch_linalg_qr_ms": qr_ms}), flush=True)


def site_tol(cfg: dict) -> float:
    """A call's tolerance: the loosest of its modes' (a bf16x3_cor
    correction at fp32 is held to bf16x3_cor's)."""
    mds = tuple(cfg.get("dot_modes", ())) + tuple(
        [cfg["gram_mode"]] if cfg.get("gram_mode") else [])
    return max(WIDE_TOL[md] for md in mds)


def wide_kernels_vs_plain(gen) -> dict:
    """Each wide kernel against its plain version at WIDE_CHECKS, every
    call kind that reaches the width; alias_q and the bitwise
    recomputation at each shape.  Returns the max abs errors."""
    errs = {}
    for (m, n), mode in WIDE_CHECKS:
        a = torch.rand(m, n, device="cuda", generator=gen) * 2 - 1
        if mode == "bf16":
            a = a.bfloat16()
        eye = torch.eye(n, device="cuda")
        rinv = eye + torch.randn(n, n, device="cuda", generator=gen) / (
            4 * math.sqrt(n))
        delta = 1e-3 * torch.randn(n, n, device="cuda",
                                   generator=gen) / math.sqrt(n)
        what = f"({m}, {n}) {mode}"
        errs[what] = {site: compare(a, cfg, site_tol(cfg),
                                    f"wide {site} {what}")
                      for site, cfg in call_sites(mode, rinv,
                                                  delta).items()}
        for dots in (dict(rinvs=(rinv,), dot_modes=(mode,)),
                     dict(rinvs=(rinv, delta), dot_modes=(mode, mode),
                          residual=(False, True))):
            p_gram = gs.stream(a, gram_mode=mode, **dots)
            q, p_q = gs.stream(a, write_q=True, gram_mode=mode,
                               out_dtype=torch.float32, **dots)
            p_re = gs.stream(q, (eye,), ("fp32",), gram_mode=mode)
            ref = gs.stream(a, write_q=True, gram_mode=mode, **dots)
            a1 = a.clone()
            got = gs.stream(a1, write_q=True, gram_mode=mode, alias_q=True,
                            **dots)
            torch.cuda.synchronize()
            if not (torch.equal(p_gram, p_q) and torch.equal(p_re, p_q)):
                raise AssertionError(f"wide {what}: bitwise recomputation "
                                     f"failed ({len(dots['rinvs'])} dots)")
            if (got[0].data_ptr() != a1.data_ptr()
                    or not (torch.equal(got[0], ref[0])
                            and torch.equal(got[1], ref[1]))):
                raise AssertionError(f"wide {what}: alias_q is not bitwise "
                                     f"the call without it")
            del q, a1, got, ref
    print(json.dumps({"wide_kernels_vs_plain": {
        "tol": WIDE_TOL, "max_abs_err": errs,
        "bitwise_recompute_and_alias_q": "ok"}}), flush=True)
    return errs


def wide_kernel_times(m: int, n: int, gen, mode: str = MODE) -> dict:
    """The wide Gram and Q-pass calls at (m, n) and ``mode``: held against
    the plain version, timed beside it, the library products (float32
    cuBLAS) and the bound (the function's bytes, and the design's with
    its extra read)."""
    a = torch.rand(m, n, device="cuda", generator=gen) * 2 - 1
    g = gs.gram_stream(a, MODE)
    rinv = torch.linalg.solve_triangular(
        torch.linalg.cholesky(g.double()).T.float(),
        torch.eye(n, device="cuda"), upper=True)
    calls = {"gram": dict(gram_mode=mode),
             "qpass": dict(rinvs=(rinv,), dot_modes=(mode,), write_q=True)}
    out = {}
    for name, cfg in calls.items():
        err = compare(a, cfg, WIDE_TOL[mode],
                      f"wide {name} ({m}, {n}) {mode}")
        dots = cfg.get("dot_modes", ())
        bound = flops.stream_bound(m, n, dots, cfg.get("gram_mode"),
                                   cfg.get("write_q", False))
        design = flops.stream_bound(m, n, dots, cfg.get("gram_mode"),
                                    cfg.get("write_q", False), design=True)
        lib = (lambda: a.T @ a) if name == "gram" else (lambda: a @ rinv)
        out[name] = {
            "max_abs_err": err,
            "ms": float(np.median(timing.time_cuda(
                lambda c=cfg: gs.stream(a, **c), reps=5, warmup=1))),
            "plain_ms": float(np.median(timing.time_cuda(
                lambda c=cfg: gs.stream_reference(a, **c), reps=2,
                warmup=1))),
            "library_ms": float(np.median(timing.time_cuda(lib, reps=5,
                                                           warmup=1))),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "design_bound_ms": design["bound_ms"],
            "design_bound_by": design["bound_by"]}
    return out


def phase_wide(gen) -> dict:
    """The wide range of the stream kernel: its kernels against their
    plain versions; the bench's ladder at (2^19, 512) through tier 1 on
    the wide kernels alone (no ``modes.gram``, no n <= 128 kernel); the
    in-place QR at (2^19, 1024) f32 within 1/8 of A above A; the compact
    CholeskyQR3 at (2^18, 1024), and at fp32 at (2^16, 2048); tsqr at
    (2^18, 256) and rsvd at rank 200 past the panel kernel's width; the
    kernels' times at (2^19, 512) and (2^18, 1024), and the fp32
    kernels' at (2^16, 2048)."""
    t0 = time.perf_counter()
    errs = wide_kernels_vs_plain(gen)
    # the wide path: the bench's ladder, modes.gram counted
    a = torch.rand(M_WIDE_LADDER, N_WIDE, device="cuda", generator=gen) * 2 - 1
    gram_calls = []
    plain_gram = modes.gram
    modes.gram = lambda *x, **kw: gram_calls.append(1) or plain_gram(*x,
                                                                     **kw)
    try:
        torch.cuda.synchronize()
        reset_counts()
        q, r, info = bench.ladder(a, return_info=True)
        torch.cuda.synchronize()
        counts = path_counts = read_counts()
    finally:
        modes.gram = plain_gram
    orth = validation.orthogonality_accurate(q)
    res = validation.residual_accurate(a, q, r)
    del q, r
    if (info["tier"] != 1 or not (orth < 1e-5 and res < 1e-5)
            or counts["stream_wide_dot"] + counts["stream_wide_gram"] < 2
            or not counts["stream_wide_dot"] or not counts["stream_wide_gram"]
            or counts["stream_gram"] or gram_calls):
        raise AssertionError(f"wide path: tier {info['tier']}, orth "
                             f"{orth:.2e}, residual {res:.2e}, launches "
                             f"{counts}, modes.gram calls {len(gram_calls)}")
    ladder_ms = timing.time_cuda(lambda: bench.ladder(a), reps=5, warmup=1)
    qr_ms = float(np.median(timing.time_cuda(lambda: torch.linalg.qr(a),
                                             reps=2, warmup=1)))
    useful = flops.qr_flops(M_WIDE_LADDER, N_WIDE)
    # where the wide path's device time goes: one traced ladder call
    with tempfile.TemporaryDirectory() as logdir:
        with profile.trace(logdir) as tr:
            bench.ladder(a)
        trace = tr.summary(top=6)
    print(json.dumps({
        "wide_path": f"bench.ladder({M_WIDE_LADDER}x{N_WIDE} f32, {MODE})",
        "tier": info["tier"], "orthogonality": orth, "residual": res,
        "launches": counts, "modes_gram_calls": len(gram_calls),
        "ladder_ms_median": float(np.median(ladder_ms)),
        "ladder_ms": ladder_ms,
        "useful_tflops": useful / float(np.median(ladder_ms)) / 1e9,
        "torch_linalg_qr_ms": qr_ms, "trace": trace}), flush=True)
    del a
    # the in-place QR at (2^19, 1024) f32: Q on A's storage, bitwise the
    # non-aliased call's, its peak above A within 1/8 of A
    a0 = torch.rand(M_WIDE_INPLACE, N_WIDE_INPLACE, device="cuda",
                    generator=gen) * 2 - 1
    inplace = {}
    for method, variant in INPLACE_CASES:
        what = f"{method}/{variant}"
        kw = {} if method == "cholqr1_fused" else {"variant": variant}
        q0, r0 = cholqr._METHODS[method](a0, MODE, **kw)
        a = a0.clone()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        q, r = tsqr_tpu_torch.fastqr_inplace(a, MODE, method, variant)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        if q.data_ptr() != a.data_ptr() or not (torch.equal(q, q0)
                                                and torch.equal(r, r0)):
            raise AssertionError(f"wide in-place {what}: not bitwise the "
                                 "non-aliased call on A's storage")
        del q0, r0
        orth = validation.orthogonality_accurate(q)
        res = validation.residual_accurate(a0, q, r)
        a_bytes = a.numel() * a.element_size()
        if not (orth < 1e-5 and res < 1e-5
                and peak <= INPLACE_WIDE_PEAK_MAX * a_bytes):
            raise AssertionError(f"wide in-place {what}: orth {orth:.2e} "
                                 f"residual {res:.2e} peak {peak} B")
        inplace[what] = {"orthogonality": orth, "residual": res,
                         "peak_bytes_above_input": peak,
                         "peak_share_of_input": peak / a_bytes}
        del a, q, r
    del a0
    print(json.dumps({"wide_inplace": f"fastqr_inplace({M_WIDE_INPLACE}x"
                                      f"{N_WIDE_INPLACE} f32, {MODE})",
                      "runs": inplace}), flush=True)
    # the compact shifted CholeskyQR3, tsqr and rsvd past n = 128
    consumers = {}
    a = torch.rand(M_WIDE_CQR3, N_WIDE_CQR3, device="cuda",
                   generator=gen) * 2 - 1
    (q, r), counts, ms = timed(lambda: cholqr.cholqr3_fused(
        a, MODE, variant="compact"))
    consumers["cholqr3_fused compact"] = {
        "shape": [M_WIDE_CQR3, N_WIDE_CQR3],
        "orthogonality": validation.orthogonality_accurate(q),
        "residual": validation.residual_accurate(a, q, r), "ms": ms,
        "launches": kernel_launches(counts)}
    del a, q, r
    # the fp32 path past 1024: the compact CholeskyQR3 at fp32, its
    # products on the fp32 kernels and its corrections at bf16x3_cor
    a = torch.rand(M_WIDE_FP32, N_WIDE_FP32, device="cuda",
                   generator=gen) * 2 - 1
    (q, r), fp32_counts, ms = timed(lambda: cholqr.cholqr3_fused(
        a, "fp32", variant="compact"))
    consumers["cholqr3_fused compact fp32"] = {
        "shape": [M_WIDE_FP32, N_WIDE_FP32],
        "orthogonality": validation.orthogonality_accurate(q),
        "residual": validation.residual_accurate(a, q, r), "ms": ms,
        "launches": kernel_launches(fp32_counts)}
    del a, q, r
    if not (fp32_counts["stream_wide_dot_fp32"]
            and fp32_counts["stream_wide_gram_fp32"]
            and fp32_counts["stream_wide_dot"]):
        raise AssertionError(f"wide fp32 path launched {fp32_counts}: the "
                             "fp32 kernels and the bf16x3_cor dots")
    a = torch.rand(M_WIDE_TSQR, N_WIDE_TSQR, device="cuda",
                   generator=gen) * 2 - 1
    (q, r), counts, ms = timed(lambda: tsqr_tpu_torch.tsqr(a, MODE))
    consumers["tsqr"] = {
        "shape": [M_WIDE_TSQR, N_WIDE_TSQR],
        "orthogonality": validation.orthogonality_accurate(q),
        "residual": validation.residual_accurate(a, q, r), "ms": ms,
        "launches": kernel_launches(counts)}
    del a, q, r
    u0 = torch.linalg.qr(torch.randn(M_RSVD, RANK_RSVD, device="cuda",
                                     generator=gen)).Q
    v0 = torch.linalg.qr(torch.randn(N_RSVD, RANK_RSVD, device="cuda",
                                     generator=gen)).Q
    s0 = torch.linspace(10, 1, RANK_RSVD, device="cuda")
    a = (u0 * s0) @ v0.T
    rgen = torch.Generator(device="cuda").manual_seed(1)
    (u, s, vt), counts, ms = timed(lambda: tmodels.rsvd(
        a, RANK_RSVD, rgen, MODE))
    consumers["rsvd"] = {
        "shape": [M_RSVD, N_RSVD], "rank": RANK_RSVD,
        "reconstruction": rel((u * s) @ vt, a), "singular_values": rel(s, s0),
        "ms": ms, "launches": kernel_launches(counts)}
    del a, u, s, vt, u0, v0
    print(json.dumps({"wide_consumers": consumers}), flush=True)
    for k, v in consumers.items():
        grade = ((v["reconstruction"], v["singular_values"]) if k == "rsvd"
                 else (v["orthogonality"], v["residual"]))
        tol = RSVD_TOL if k == "rsvd" else 1e-5
        if not max(grade) < tol:
            raise AssertionError(f"wide {k}: {grade} not below {tol:g}")
    times = {f"{m}x{n}": wide_kernel_times(m, n, gen)
             for m, n in ((M_WIDE_LADDER, N_WIDE),
                          (M_WIDE_CQR3, N_WIDE_CQR3))}
    times_fp32 = wide_kernel_times(M_WIDE_FP32, N_WIDE_FP32, gen, "fp32")
    print(json.dumps({"wide_kernel_times": times, "mode": MODE,
                      "wide_kernel_times_fp32": {
                          f"{M_WIDE_FP32}x{N_WIDE_FP32}": times_fp32},
                      "seconds": time.perf_counter() - t0}), flush=True)
    return {"counts": path_counts, "errs": errs, "times": times,
            "fp32_counts": fp32_counts, "times_fp32": times_fp32}


def phase_tiers(seed: int) -> None:
    for kappa, want in ((1024, 2), (1 << 18, 3)):
        a_np, measured = latms.rand_matrix_with_cond(seed + kappa, M_TIERS,
                                                     N, kappa)
        a = torch.from_numpy(a_np).cuda()
        reset_counts()
        q, r, info = tsqr_tpu_torch.qr_auto_fused(a, MODE, return_info=True)
        torch.cuda.synchronize()
        launches = read_counts()["stream_gram"]
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
        launches = read_counts()["stream_gram"]
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
    m_eff = min(2^20, 2^28 / n), n = 128 .. 2048: the rows the JAX
    package's ``sweep`` makes, a fused row wherever the mode's range
    reaches n (1024 for bf16x6_cor and bf16x3_cor, 2048 for the others),
    else its non-fused sibling's once ("safe"); no row flagged, every
    fused corrected-mode row below 1e-5 orthogonality.  The non-fused
    siblings at n = 2048 sum their Grams in plain float32 products over
    2^17 rows, uncompensated (``modes.gram``, as the JAX package's): they
    read 2.8-4.2e-5 on the card and are printed, not held to 1e-5, which
    leaves that part of the sweep's grade unmet (PERF.md, open
    questions)."""
    t0 = time.perf_counter()
    rows, errors = mfu.sweep(m=M_MAIN, ns=MFU_NS)
    if errors:
        raise AssertionError(f"mfu sweep errors: {errors}")
    def in_range(md, n):
        return n <= cholqr._fused_n_max(modes.resolve(md))

    want = sum(1 if in_range(md, n) else int(v == "safe")
               for md, _, v in mfu.CONFIGS for n in MFU_NS)
    fused = sum(r["method"].endswith("_fused") for r in rows)
    want_fused = sum(in_range(md, n) for md, _, _ in mfu.CONFIGS
                     for n in MFU_NS)
    flagged = [r for r in rows if r["flag"]]
    loose = [r for r in rows if r["compute_mode"] in ("bf16x6_cor",
                                                      "bf16x3_cor")
             and r["method"].endswith("_fused")
             and not r["orthogonality"] < CORRECTED_ORTH_MAX]
    print(json.dumps({"mfu_rows": len(rows), "fused_rows": fused,
                      "seconds": time.perf_counter() - t0}), flush=True)
    if len(rows) != want or fused != want_fused or flagged or loose:
        raise AssertionError(f"mfu sweep: {len(rows)} rows (want {want}), "
                             f"{fused} fused (want {want_fused}), flagged "
                             f"{flagged}, fused corrected rows above "
                             f"{CORRECTED_ORTH_MAX:g}: {loose}")


def phase_qr_auto(gen) -> None:
    """qr_auto takes cholqr3 on a uniform input and BlockQR on a
    zero-column one; qr_auto_fused takes tier 1 at n = 512 on the wide
    kernels."""
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
    if counts["stream_gram"] or not (counts["stream_wide_dot"]
                                     and counts["stream_wide_gram"]):
        raise AssertionError(f"qr_auto_fused at n = 512 launched {counts}: "
                             "the wide kernels alone")


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


def update_inputs(m: int, p_rows: int, gen) -> dict:
    """The extra operands of the five updates of an (m, N) factorization,
    uniform[-1, 1] from ``gen``, on its device: ``p_rows`` rows to append
    (and as many to delete), P_COLS columns, a rank-RANK U V^T."""
    dev = gen.device

    def u(*shape):
        return torch.empty(*shape, device=dev).uniform_(-1, 1, generator=gen)

    return {"b_rows": u(p_rows, N), "b_cols": u(m, P_COLS), "u": u(m, RANK),
            "v": u(N, RANK)}


def apply_update(name: str, a, q, r, x: dict, mode: str, device=None):
    """(modified A, Q', R') of one update of A = Q R."""
    p_del = x["b_rows"].shape[0]
    keep = [j for j in range(N) if j not in DROP_COLS]
    if name == "append_rows":
        return (torch.cat([a, x["b_rows"]]), *update.qr_append_rows(
            q, r, x["b_rows"], mode, device=device))
    if name == "append_cols":
        return (torch.cat([a, x["b_cols"]], dim=1), *update.qr_append_cols(
            q, r, x["b_cols"], mode, device=device))
    if name == "delete_cols":
        return (a[:, keep], *update.qr_delete_cols(q, r, DROP_COLS, mode,
                                                   device=device))
    if name == "delete_rows":
        return (a[p_del:], *update.qr_delete_rows(q, r, p_del, mode,
                                                  device=device))
    return (a + x["u"] @ x["v"].T, *update.qr_rank_update(
        q, r, x["u"], x["v"], mode, device=device))


def sign_fixed(r, ref):
    """R with its rows' signs made those of ``ref``'s diagonal: two
    Householder factorizations of one matrix agree up to them."""
    s = torch.sign(torch.diagonal(r)) * torch.sign(torch.diagonal(ref))
    return r * s[:, None]


def phase_update(seed: int) -> None:
    """The five updates of core/update.py on the bench's (2^20, 128)
    input in each mode: each held to the device metrics, beside a fresh
    qr of the modified matrix (its metrics, R up to row signs, its time),
    and to the same update on the CPU at (4096, 128) from the same
    factors."""
    t0 = time.perf_counter()
    out = {}
    for mode in UPDATE_MODES:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        a = torch.empty(M_MAIN, N, device="cuda").uniform_(-1, 1,
                                                           generator=gen)
        x = update_inputs(M_MAIN, P_ROWS, gen)
        q, r = tsqr_tpu_torch.qr(a, mode)
        gen_cpu = torch.Generator().manual_seed(seed)
        a_s = torch.empty(M_UPDATE_CPU, N).uniform_(-1, 1, generator=gen_cpu)
        x_s = update_inputs(M_UPDATE_CPU, M_UPDATE_CPU // 8, gen_cpu)
        q_s, r_s = tsqr_tpu_torch.qr(a_s, mode, device="cpu")
        for name in UPDATES:
            torch.cuda.synchronize()
            reset_counts()
            a2, q2, r2 = apply_update(name, a, q, r, x, mode)
            torch.cuda.synchronize()
            counts = read_counts()
            orth = float(validation.orthogonality_wide_device(q2))
            res = float(validation.residual_device_chunked(a2, q2, r2))
            qf, rf = tsqr_tpu_torch.qr(a2, mode)
            fresh = {"orthogonality": float(
                validation.orthogonality_wide_device(qf)),
                "residual": float(validation.residual_device_chunked(
                    a2, qf, rf)),
                "r_rel_diff": rel(sign_fixed(r2, rf), rf)}
            del qf, rf
            upd_ms = timing.time_cuda(
                lambda: apply_update(name, a, q, r, x, mode), reps=3,
                warmup=1)
            fresh_ms = timing.time_cuda(
                lambda: tsqr_tpu_torch.qr(a2, mode), reps=3, warmup=1)
            # the same update of the same CPU factors, on the card and
            # on the CPU
            _, q_c, r_c = apply_update(name, a_s.cuda(), q_s.cuda(),
                                       r_s.cuda(),
                                       {k: v.cuda() for k, v in x_s.items()},
                                       mode)
            _, q_h, r_h = apply_update(name, a_s, q_s, r_s, x_s, mode,
                                       device="cpu")
            tol = auto._TOL[auto.M(mode)]
            cpu = {"r_rel_diff": rel(r_c.cpu(), r_h),
                   "q_rel_diff": rel(q_c.cpu(), q_h)}
            row = {"shape": list(q2.shape), "orthogonality": orth,
                   "residual": res, "launches": counts,
                   "ms_median": float(np.median(upd_ms)), "ms": upd_ms,
                   "fresh_qr_ms_median": float(np.median(fresh_ms)),
                   "fresh_qr": fresh, "vs_cpu_4096": cpu, "tol": tol}
            out[f"{name} {mode}"] = row
            print(json.dumps({"update": f"{name} {mode}", **row}),
                  flush=True)
            if not (orth < UPDATE_TOL and res < UPDATE_TOL):
                raise AssertionError(f"update {name} {mode}: orth "
                                     f"{orth:.2e} residual {res:.2e}")
            if not (cpu["r_rel_diff"] <= tol and cpu["q_rel_diff"] <= tol):
                raise AssertionError(f"update {name} {mode} against the "
                                     f"CPU: {cpu} (tol {tol})")
            if name != "delete_rows" and counts["panel_qr"] < 1:
                raise AssertionError(f"update {name} {mode} launched no "
                                     f"panel kernel: {counts}")
            del a2, q2, r2
        del a, q, r, x
    print(json.dumps({"update_path": f"core/update.py on ({M_MAIN}, {N}) "
                      f"f32, modes {list(UPDATE_MODES)}",
                      "cases": len(out), "max_orthogonality": max(
                          v["orthogonality"] for v in out.values()),
                      "max_residual": max(v["residual"]
                                          for v in out.values()),
                      "seconds": time.perf_counter() - t0}), flush=True)


def check_corrected(rows: list[dict], what: str) -> float:
    """Largest orthogonality of the bf16x6_cor rows; raises above the
    mode's promise."""
    orths = [r["orthogonality"] if "orthogonality" in r
             else math.hypot(r["diag"], r["offdiag"])
             for r in rows if r["compute_mode"] == "bf16x6_cor"]
    worst = max(orths)
    if not worst < CORRECTED_ORTH_MAX:
        raise AssertionError(f"{what}: a bf16x6_cor row's orthogonality "
                             f"{worst:.2e} >= {CORRECTED_ORTH_MAX}")
    return worst


def phase_harness(seed: int) -> None:
    """The reference's accuracy experiments at its sizes: the cond sweep,
    the quick accuracy grid and the full grid's widest corner, eval_q at
    n = 1024, the float64 golden comparison and the fp16-range study on
    the tier-1 input.  Each CSV block goes to stdout with its header."""
    reset_counts()
    t0 = time.perf_counter()
    conds = [2.0 ** k for k in range(2, 16)]
    cond_rows, e1 = cond.sweep(M_REF, N, conds, ["fp32", "bf16x6_cor"],
                               trials=1, seed=seed)
    acc_rows, e2 = accuracy.sweep(harness_main.QUICK_MS,
                                  harness_main.QUICK_NS, harness_main.MODES,
                                  trials=4, seed=seed)
    wide_rows, e3 = accuracy.sweep([M_REF], [N_REF_WIDE], ["bf16x6_cor"],
                                   reorths=(False, True), trials=2,
                                   seed=seed)
    if e1 or e2 or e3:
        raise AssertionError(f"harness sweep errors: {e1 + e2 + e3}")
    q_rows = eval_q.sweep(harness_main.QUICK_MS, N_REF_WIDE,
                          ["fp32", "bf16x6_cor"], seed=seed)
    golden = compare_mod.compare_to_fp64_golden(M_REF, N, MODE, seed=seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.empty(M_MAIN, N, device="cuda").uniform_(-1, 1, generator=gen)
    study = experimental.fp16_range_study(
        a, lambda x: tsqr_tpu_torch.qr_auto_fused(x, MODE))
    del a
    worst = {"cond": check_corrected(cond_rows, "cond"),
             "accuracy": check_corrected(acc_rows + wide_rows, "accuracy"),
             "eval_q": check_corrected(q_rows, "eval_q")}
    if not (golden["r_diag_max_rel_diff"] < 1e-5
            and study["orthogonality"] < CORRECTED_ORTH_MAX
            and study["orthogonality_fp16_range"] < CORRECTED_ORTH_MAX):
        raise AssertionError(f"golden {golden}, fp16 study {study}")
    print(json.dumps({"harness": {
        "rows": {"cond": len(cond_rows), "accuracy": len(acc_rows)
                 + len(wide_rows), "eval_q": len(q_rows)},
        "bf16x6_cor_max_orthogonality": worst,
        "compare_to_fp64_golden": {"shape": [M_REF, N], "mode": MODE,
                                   **golden},
        "fp16_range_study": {"shape": [M_MAIN, N], "qr": "qr_auto_fused",
                             **study},
        "launches": read_counts(),
        "seconds": time.perf_counter() - t0}}), flush=True)


def phase_profile(tier4: dict) -> None:
    """BlockQR's ablation breakdown at (2^18, 512) fp32, the tree's
    compute-R / compute-Q split at (2^20, 128), and one tier-4 ladder
    call and one qr at (2^18, 512) under torch.profiler: each trace's
    kernel count, device-busy share and three longest kernels."""

    t0 = time.perf_counter()
    bd = profile.blockqr_breakdown(M_WIDE, N_WIDE, "fp32", out=sys.stdout)
    split = profile.tsqr_phase_split(M_MAIN, N, "fp32", out=sys.stdout)
    wide = torch.rand(M_WIDE, N_WIDE, device="cuda") * 2 - 1
    traces = {}
    with tempfile.TemporaryDirectory() as logdir:
        calls = {
            "tier4_ladder": lambda: tsqr_tpu_torch.qr_auto_fused(
                tier4["a"], MODE),
            "qr_wide": lambda: tsqr_tpu_torch.qr(wide, "fp32",
                                                 reorth=True)}
        for what, call in calls.items():
            call()  # warm
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            with profile.trace(logdir) as tr:
                call()
            traces[what] = {"trace_mb": os.path.getsize(tr.path) / 2**20,
                            "traced_s": time.perf_counter() - t1,
                            **tr.summary(top=3)}
    del wide
    print(json.dumps({"profile": {
        "blockqr_breakdown": {"shape": [M_WIDE, N_WIDE], "mode": "fp32",
                              **bd},
        "tsqr_phase_split": {"shape": [M_MAIN, N], "mode": "fp32", **split},
        "traces": traces, "seconds": time.perf_counter() - t0}}),
        flush=True)


def timed(fn, reps: int = 3):
    """``fn()`` ``reps`` times between CUDA events: the first call's
    result, the kernel launches of that call (counts set to 0 just before
    it, read just after), and the milliseconds of every call."""
    out = counts = None
    times = []
    for i in range(reps):
        torch.cuda.synchronize()
        if i == 0:
            reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        res = fn()
        end.record()
        end.synchronize()
        if i == 0:
            out, counts = res, read_counts()
        times.append(start.elapsed_time(end))
        del res
    return out, counts, times


def kernel_launches(counts: dict) -> dict:
    return {k: counts[k] for k in ("stream_gram", "stream_gram_reduce",
                                   "stream_wide_dot", "stream_wide_gram",
                                   "stream_wide_dot_fp32",
                                   "stream_wide_gram_fp32", "panel_qr",
                                   "panel_qr_wide", "split_mm")}


def regen_q_orthogonality(mode: str) -> dict:
    """qr_regen at (M_REGEN_Q, N) from the phase's generator, then
    Q = A rinv formed chunk by chunk and graded by the chunked device
    metrics: the QR's own grade, beside its streamed estimate."""
    io = torch.bfloat16 if mode == "bf16" else torch.float32
    gen = ooc.uniform_gen(REGEN_SEED, REGEN_CHUNK, N, dtype=io)
    r, info = ooc.qr_regen(gen, M_REGEN_Q, N, mode, "cholqr2", REGEN_CHUNK)
    q = torch.cat([modes.mm_fp32(gen(i), info["rinv"])
                   for i in range(M_REGEN_Q // REGEN_CHUNK)])
    out = {"shape": [M_REGEN_Q, N], "mode": mode, "method": "cholqr2",
           "q_orthogonality_chunked_device": float(
               validation.orthogonality_wide_device(q)),
           "q_residual_chunked_device": float(
               validation.residual_regen_chunked(gen, q, r, REGEN_CHUNK)),
           "streamed_orthogonality": float(info["orthogonality"])}
    del q
    return out


def phase_regen() -> dict:
    """The matrix-free QR at the reference's m = 2^26 edge: qr_regen at
    (2^26, 128), chunks of 2^21 made on the card, bf16 cholqr1 and
    bf16x6_cor cholqr2 (data/bigm2.csv's rows), a CSV block in that
    file's schema; the QR's own grade at 2^22 by the chunked device
    metric; lstsq_regen at (2^26, 128)."""
    rows, out = [], {}
    for mode, method in REGEN_CASES:
        io = torch.bfloat16 if mode == "bf16" else torch.float32
        gen = ooc.uniform_gen(REGEN_SEED, REGEN_CHUNK, N, dtype=io)
        prog = ooc.regen_program(gen, M_REGEN, N, mode, method, REGEN_CHUNK)
        (r, orth, res, _), counts, ms = timed(prog)
        orth, res = float(orth), float(res)
        t = float(np.median(ms)) / 1e3
        rows.append(f"{M_REGEN},{N},{mode},{method}_regen[device_streamed],"
                    f"{t:.6e},{flops.qr_flops(M_REGEN, N) / t / 1e12:.3f},"
                    f"{orth:.3e},{res:.3e}")
        out[f"{mode} {method}"] = {
            "ms_median": float(np.median(ms)), "ms": ms,
            "orthogonality": orth, "residual": res,
            "jax_bigm2_orthogonality_residual": JAX_BIGM2[mode],
            "launches": kernel_launches(counts)}
        if mode == "bf16" and not (orth < auto._TOL[auto.M(mode)]
                                   and res < auto._TOL[auto.M(mode)]):
            raise AssertionError(f"qr_regen {mode}: orthogonality {orth:.2e}"
                                 f", residual {res:.2e}")
        # held to 3x the JAX package's streamed figure at this shape; the
        # QR's own grade is read at 2^22 below
        if mode == "bf16x6_cor" and not (res < 1e-5
                                         and orth < REGEN_ORTH_MAX):
            raise AssertionError(f"qr_regen {mode} at 2^26: orth "
                                 f"{orth:.2e} (max {REGEN_ORTH_MAX:.2e}), "
                                 f"residual {res:.2e}")
        if mode == "bf16x6_cor":
            r_bf16x6 = r.float().cpu()   # the distributed phase's reference
        del r
    print("regen_csv (data/bigm2.csv schema; the JAX package's rows at this "
          "shape read orthogonality, residual "
          + "; ".join(f"{md} {o:.3e}, {e:.3e}"
                      for md, (o, e) in JAX_BIGM2.items())
          + ", for grade only):")
    print("m,n,compute_mode,method,elapsed_time,tflops,orthogonality,"
          "residual")
    print("\n".join(rows), flush=True)
    q_grade = regen_q_orthogonality("bf16x6_cor")
    if not (q_grade["q_orthogonality_chunked_device"] < 1e-5
            and q_grade["q_residual_chunked_device"] < 1e-5):
        raise AssertionError(f"qr_regen Q at 2^22: {q_grade}")
    out["q_at_2^22"] = q_grade

    # least squares over the same generator: b = A x* + noise
    gen = ooc.uniform_gen(REGEN_SEED, REGEN_CHUNK, N, dtype=torch.float32)
    g = torch.Generator(device="cuda").manual_seed(REGEN_SEED)
    x_star = torch.randn(N, device="cuda", generator=g)
    b = torch.cat([gen(i) @ x_star for i in range(M_REGEN // REGEN_CHUNK)])
    b += 1e-3 * torch.randn(M_REGEN, device="cuda", generator=g)
    lstsq_mod = importlib.import_module("tsqr_tpu_torch.models.lstsq")
    (x, info), counts, ms = timed(lambda: lstsq_mod.lstsq_regen(
        gen, b, M_REGEN, N, "bf16x6_cor", chunk_rows=REGEN_CHUNK), reps=1)
    err = rel(x, x_star)
    out["lstsq_regen bf16x6_cor"] = {
        "ms": ms, "residual": float(info["residual"]),
        "orthogonality": float(info["orthogonality"]),
        "x_rel_err_vs_x_star": err, "launches": kernel_launches(counts)}
    del b
    if not err < 1e-4:
        raise AssertionError(f"lstsq_regen at 2^26: x off x* by {err:.2e}")
    return out, r_bf16x6


def host_uniform(m: int, seed: int) -> torch.Tensor:
    """An (m, N) float32 host tensor of uniform[-1, 1] made chunk by chunk
    on the card (ooc.uniform_gen) and copied down."""
    a = torch.empty(m, N)
    gen = ooc.uniform_gen(seed, OOC_CHUNK, N, dtype=torch.float32)
    for i, lo in enumerate(range(0, m, OOC_CHUNK)):
        a[lo:lo + OOC_CHUNK].copy_(gen(i))
    return a


def staging_rates(a: torch.Tensor, q: torch.Tensor) -> dict:
    """H2D and D2H GB/s through the module's pair of pinned staging
    buffers, a chunk at a time over all of A (up) and into all of Q's rows
    (down), with no compute between.  An untimed pass first allocates the
    pinned pair and touches Q's fresh pages (a first touch is several
    times slower), as the QR's own first Q pass would."""
    out = {}
    st = ooc._Staging(torch.device("cuda"))
    x = st.h2d(a, 0, OOC_CHUNK)
    for lo in range(0, q.shape[0], OOC_CHUNK):
        st.d2h(x, q, lo, lo + OOC_CHUNK)
    st.flush()
    for direction in ("h2d", "d2h"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for lo in range(0, a.shape[0], OOC_CHUNK):
            if direction == "h2d":
                x = st.h2d(a, lo, lo + OOC_CHUNK)
            else:
                st.d2h(x, q, lo, lo + OOC_CHUNK)
        st.flush()
        torch.cuda.synchronize()
        out[f"{direction}_gbps"] = a.numel() * 4 / (
            time.perf_counter() - t0) / 1e9
    return out


def phase_ooc_host() -> dict:
    """qr_out_of_core at (2^25, 128) f32 in host memory, bf16x6_cor
    cholqr3 with the in-pass metrics, then ooc_orthogonality and
    ooc_residual over the returned Q; seconds a pass, the staging's H2D
    and D2H rates, and the call's effective rate."""
    t0 = time.perf_counter()
    a = host_uniform(M_OOC, REGEN_SEED + 1)
    q = torch.empty_like(a)
    made_s = time.perf_counter() - t0
    rates = staging_rates(a, q)
    reset_counts()
    t0 = time.perf_counter()
    q, r, info = ooc.qr_out_of_core(a, "bf16x6_cor", "cholqr3", OOC_CHUNK,
                                    out=q, metrics=True)
    qr_s = time.perf_counter() - t0
    counts = kernel_launches(read_counts())
    t0 = time.perf_counter()
    orth = ooc.ooc_orthogonality(q, OOC_CHUNK)
    orth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = ooc.ooc_residual(a, q, r, OOC_CHUNK)
    res_s = time.perf_counter() - t0
    gib = a.numel() * 4 / 2**30
    # cholqr3 without a checkpoint: 3 Gram passes (A up) and 3 Q passes
    # (A up, Q down)
    moved = 9 * a.numel() * 4
    out = {"shape": [M_OOC, N], "mode": "bf16x6_cor", "method": "cholqr3",
           "host_gib_a_and_q": 2 * gib, "make_a_s": made_s,
           "qr_s": qr_s, "s_per_pass": qr_s / 6,
           "effective_gbps": moved / qr_s / 1e9, **rates,
           "inpass": info, "ooc_orthogonality": orth,
           "ooc_orthogonality_s": orth_s, "ooc_residual": res,
           "ooc_residual_s": res_s, "launches": counts}
    del a, q
    if not (info["orthogonality"] < 1e-5 and info["residual"] < 1e-5
            and orth < 1e-5 and res < 1e-5):
        raise AssertionError(f"qr_out_of_core at 2^25: {out}")
    return out


def resume_child(workdir: str) -> int:
    """The child of the resume check: the checkpointed QR over the
    parent's memmapped A, killed by its injected fault mid Gram pass."""
    a = np.load(os.path.join(workdir, "a.npy"), mmap_mode="r")
    out = np.load(os.path.join(workdir, "q.npy"), mmap_mode="r+")
    try:
        ooc.qr_out_of_core(a, "fp32", "cholqr3", RESUME_CHUNK, out=out,
                           metrics=True,
                           checkpoint=os.path.join(workdir, "ck.npz"),
                           _fault_after=RESUME_FAULT)
    except ooc.OOCInterrupted:
        out.flush()
        os._exit(RESUME_EXIT)  # a death, not a return: no clean-up runs
    return 1


def phase_resume() -> dict:
    """A child process runs the checkpointed qr_out_of_core at (2^22, 128)
    f32 cholqr3 with an np.memmap ``out`` and dies in its second Gram
    pass; the parent resumes it; Q, R and the metrics must be bitwise the
    parent's uninterrupted run."""

    t0 = time.perf_counter()
    a = host_uniform(M_RESUME, REGEN_SEED + 2)
    q0, r0, info0 = ooc.qr_out_of_core(a, "fp32", "cholqr3", RESUME_CHUNK,
                                       metrics=True)
    with tempfile.TemporaryDirectory() as wd:
        np.save(os.path.join(wd, "a.npy"), a.numpy())
        out = np.lib.format.open_memmap(os.path.join(wd, "q.npy"), "w+",
                                        np.float32, tuple(a.shape))
        del out
        child = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--resume-child",
             wd], capture_output=True, text=True, timeout=600)
        ck = os.path.join(wd, "ck.npz")
        if child.returncode != RESUME_EXIT or not os.path.exists(ck):
            raise AssertionError(f"resume child exited {child.returncode} "
                                 f"(want {RESUME_EXIT}), checkpoint "
                                 f"{os.path.exists(ck)}: {child.stderr}")
        step = int(np.load(ck)["it"]), int(np.load(ck)["chunk"])
        out = np.load(os.path.join(wd, "q.npy"), mmap_mode="r+")
        q1, r1, info1 = ooc.qr_out_of_core(
            np.load(os.path.join(wd, "a.npy"), mmap_mode="r"), "fp32",
            "cholqr3", RESUME_CHUNK, out=out, metrics=True, checkpoint=ck)
        same = (torch.equal(torch.from_numpy(np.asarray(q1)), q0)
                and torch.equal(r1, r0) and info1 == info0)
        left = os.path.exists(ck)
        del q1, out
    if not same or left:
        raise AssertionError(f"resume: bitwise {same}, checkpoint left "
                             f"{left}")
    return {"shape": [M_RESUME, N], "chunk": RESUME_CHUNK,
            "fault_after_step": RESUME_FAULT,
            "checkpoint_at_it_chunk": step, "bitwise": same,
            "inpass": info0, "seconds": time.perf_counter() - t0}


def phase_ooc() -> dict:
    t0 = time.perf_counter()
    out = {}
    out["regen"], out["regen_r"] = phase_regen()
    print(json.dumps({"ooc_regen": out["regen"]}), flush=True)
    out["host"] = phase_ooc_host()
    print(json.dumps({"ooc_host": out["host"]}), flush=True)
    out["resume"] = phase_resume()
    print(json.dumps({"ooc_resume": out["resume"]}), flush=True)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps({"ooc_phase_seconds": out["seconds"]}), flush=True)
    return out


# the float64 gates of each model entry, on the single card and on the
# mesh route alike (readings of harness/dist.py's model_runs); x's
# forward error in lstsq is kappa = 1e2 times the factorization's grade;
# Nystrom's lam carries the float32 whitening's error, which grows with
# the order in both packages
def _below(limit: float, *keys):
    return lambda r: all(r[k] < limit for k in keys)


MODEL_GATES = {
    "tsqr_svd": _below(MODEL_TOL, "s_rel_err_vs_fp64", "u_orthogonality",
                       "residual"),
    "polar": lambda r: (_below(MODEL_TOL, "u_orthogonality", "residual")(r)
                        and r["h_asymmetry"] == 0
                        and r["h_min_eig_rel"] > -1e-5),
    "procrustes": lambda r: (r["rotation_err"] < 1e-3
                             and r["orthogonality"] < MODEL_TOL),
    "rsvd": _below(MODEL_TOL, "u_orthogonality", "residual"),
    "block_lanczos": _below(MODEL_TOL, "basis_orthogonality", "top_rel_err"),
    "lstsq ridge=0.0": _below(1e2 * MODEL_TOL, "x_rel_err_vs_fp64"),
    "lstsq ridge=0.01": _below(1e2 * MODEL_TOL, "x_rel_err_vs_fp64"),
    "lstsq_cgls": lambda r: r["iters"] <= 80 and r["residual_excess"] < 1e-3,
    "pivoted_qr": lambda r: (r["rank_from_diag_b"] == N // 2 and _below(
        MODEL_TOL, "residual", "q_orthogonality")(r)),
    "interpolative": _below(1e-4, "reconstruction"),
    "cur": _below(1e-4, "reconstruction"),
    "subspace_iteration": _below(MODEL_TOL, "eig_rel_err",
                                 "v_orthogonality"),
    "nystrom": lambda r: (r["lam_rel_err"] < 5e-2
                          and r["u_orthogonality"] < MODEL_TOL),
    "cca": lambda r: min(r["top2"]) > 0.99 and r["rest_max"] < 0.2,
}
MODEL_GATES["cca auto"] = MODEL_GATES["cca cholqr2"] = MODEL_GATES["cca"]


def readings(row: dict) -> dict:
    """A model row without its result tensors, for a JSON line."""
    return {k: v for k, v in row.items() if not isinstance(v, torch.Tensor)}


def phase_models(seed: int) -> dict:
    """Every entry of models/ on the card at the width its users run
    (``harness/dist.py``'s ``model_runs``, which the distributed phase's
    mesh routes share): the float64 gates of MODEL_GATES per entry, ms
    (3 calls between CUDA events) and the stream and panel kernel
    launches of its first call, counted from 0."""
    t0 = time.perf_counter()
    rows = dist_h.model_runs(seed, count=dist_h.Count(), reps=3)
    failed = []
    for name, row in rows.items():
        row["ms_median"] = float(np.median(row["ms"]))
        print(json.dumps({"model": name, **readings(row)}), flush=True)
        if not MODEL_GATES[name](row):
            failed.append(name)
    if failed:
        raise AssertionError(f"models phase: {failed}")
    if rows["pivoted_qr"]["launches"]["panel_qr"] < 1:
        raise AssertionError("pivoted_qr did not reach tier 4's panel kernel")
    seconds = time.perf_counter() - t0
    print(json.dumps({"models_phase_seconds": seconds}), flush=True)
    return {"rows": rows, "seconds": seconds}


def phase_distributed(seed: int, ooc_run: dict, models_run: dict) -> dict:
    """The distributed layer on the card: ``parallel.launch.spawn`` of
    DIST_WORLD ranks on card 0 (gloo, the payloads staged through host
    memory), each holding (2^20, 128) of a global (2^22, 128); every
    driver, the models' mesh routes and three drivers' gradients
    (``harness/dist.py``), each held to the single-card result of the
    same global input (the models phase's rows for the models); then a
    one-rank NCCL group.  Prints the ``distributed`` JSON line and
    returns the ranks' kernel launches."""
    t0 = time.perf_counter()
    ref = {}
    singles = {
        "dqr_auto tier1": lambda a: tsqr_tpu_torch.qr_auto_fused(
            a, MODE, return_info=True),
        "dtsqr allgather": lambda a: tsqr_tpu_torch.tsqr(a, MODE),
        "dcholqr cholqr2 fp32": lambda a: cholqr.fastqr(a, "fp32", "cholqr2"),
        "dcholqr cholqr3 fp32": lambda a: cholqr.fastqr(a, "fp32", "cholqr3"),
        "dcholqr cholqr2 bf16x6_cor": lambda a: cholqr.fastqr(a, MODE,
                                                              "cholqr2"),
        "dcholqr cholqr3 bf16x6_cor": lambda a: cholqr.fastqr(a, MODE,
                                                              "cholqr3"),
        "dqr reorth": lambda a: tsqr_tpu_torch.qr(a, MODE, reorth=True),
    }
    singles["dqr_auto tier4"] = singles["dqr_auto tier1"]
    singles["dtsqr butterfly"] = singles["dtsqr_hier 2x2"] = singles[
        "dtsqr allgather"]
    glob, done = {}, {}
    for name, (kind, _) in dist_h.DRIVERS.items():
        if kind not in glob:
            glob = {kind: torch.cat([dist_h.driver_input(kind, seed, i)
                                     for i in range(DIST_WORLD)])}
        a, fn = glob[kind], singles[name]
        key = (kind, fn)   # the three trees share one single-card tsqr
        if key not in done:
            out, ms = dist_h._timed(lambda: fn(a))
            ms = [ms] + timing.time_cuda(lambda: fn(a), reps=2, warmup=0)
            done[key] = {"r": out[1].float().cpu(),
                         "tier": out[2]["tier"] if len(out) == 3 else None,
                         "ms": float(np.median(ms))}
            del out
        ref[name] = done[key]
    a = glob.get("a")
    if a is None:
        a = torch.cat([dist_h.driver_input("a", seed, i)
                       for i in range(DIST_WORLD)])
    sk_gen = torch.Generator(device=dist_h.DEVICE).manual_seed(seed)
    ref["dsketch"] = {"ms": float(np.median(timing.time_cuda(
        lambda: cholqr.sketch_gaussian(a, sk_gen, dist_h.SKETCH_L), reps=3,
        warmup=0))), "s": torch.linalg.svdvals(ref["dtsqr allgather"]["r"]
                                               .double())}
    ref["dqr_regen"] = {"r": ooc_run["regen_r"],
                        "ms": ooc_run["regen"]["bf16x6_cor cholqr2"]
                        ["ms_median"]}
    del glob, a
    torch.cuda.empty_cache()
    t_drivers = time.perf_counter() - t0
    ga, w1, w2 = dist_h.grad_inputs(seed)
    gm = dist_h.GRAD_MODE
    entries = {"dtsqr": lambda x: tsqr_tpu_torch.tsqr(x, gm),
               "dcholqr": lambda x: tsqr_tpu_torch.fastqr(x, gm, "cholqr3"),
               "dqr_auto": lambda x: tsqr_tpu_torch.qr_auto_fused(x, gm)}
    ref_grads = {}
    for name, entry in entries.items():
        x = ga.clone().requires_grad_()
        q, r = entry(x)
        dist_h.loss(q, r, w1, w2).backward()
        ref_grads[name] = x.grad.cpu()
    del ga, w1, w2, x, q, r
    torch.cuda.empty_cache()
    t_ref = time.perf_counter() - t0

    backend = launch.pick_backend(DIST_WORLD, "cuda")
    t1 = time.perf_counter()
    ranks = launch.spawn(DIST_WORLD, dist_h.driver_rank, (seed,),
                         device="cuda", timeout=DIST_TIMEOUT)
    t_ranks = time.perf_counter() - t1
    nccl = launch.spawn(1, dist_h.nccl_rank, (seed,), backend="nccl",
                        device="cuda", timeout=DIST_TIMEOUT)[0]

    drivers, failures = {}, []
    for name in list(dist_h.DRIVERS) + ["dqr_regen", "dsketch"]:
        rows = [rk["drivers"][name] for rk in ranks]
        row = {"ms_max_over_ranks": max(float(np.median(x["ms"]))
                                        for x in rows),
               "single_card_ms": ref[name]["ms"],
               "wire": rows[0]["wire"],
               "panel_launches_per_rank": [x["launches"]["panel_qr"]
                                           for x in rows]}
        if name == "dsketch":
            b = rows[0]["b"].double()
            ratio = (torch.linalg.svdvals(b) / math.sqrt(dist_h.SKETCH_L)
                     / ref["dsketch"]["s"])
            row["sketch_sv_ratio"] = [float(ratio.min()), float(ratio.max())]
            row["b_same_on_every_rank"] = all(torch.equal(x["b"], rows[0]["b"])
                                              for x in rows)
            ok = (0.2 < row["sketch_sv_ratio"][0]
                  and row["sketch_sv_ratio"][1] < 5.0
                  and row["b_same_on_every_rank"])
        else:
            r = rows[0]["r"]
            md = name.split()[-1] if name.startswith("dcholqr") else MODE
            tol = auto._TOL[auto.M(md)]
            row.update(orthogonality=rows[0]["orthogonality"],
                       residual=rows[0]["residual"],
                       r_max_diff_across_ranks=max(
                           float((x["r"] - r).abs().max()) for x in rows))
            r1 = ref[name]["r"]
            if name == "dqr_auto tier4":
                # a zero column: R's rows past it are not unique, R^T R
                # (= A^T A) is
                r, r1 = r.double(), r1.double()
                row["rtr_rel_vs_single_card"] = rel(r.T @ r, r1.T @ r1)
            else:
                row["r_rel_vs_single_card"] = rel(sign_fixed(r, r1), r1)
            ok = (row["orthogonality"] < DIST_TOL
                  and row["residual"] < DIST_TOL
                  and max(row.get("r_rel_vs_single_card", 0.0),
                          row.get("rtr_rel_vs_single_card", 0.0)) <= tol)
            if name in dist_h.TREE_DRIVERS:
                ok = ok and row["r_max_diff_across_ranks"] == 0.0
            if "tier" in rows[0]:
                row["tier"] = [x["tier"] for x in rows]
                row["single_card_tier"] = ref[name]["tier"]
                ok = ok and set(row["tier"]) == {ref[name]["tier"]}
        row["ok"] = bool(ok)
        if not ok:
            failures.append(name)
        drivers[name] = row

    models_rows = {}
    for name, got in ranks[0]["models"].items():
        single = models_run["rows"][name]
        # first calls on both sides
        row = {"ms_max_over_ranks": max(rk["models"][name]["ms"][0]
                                        for rk in ranks),
               "single_card_ms": single["ms"][0],
               "panel_launches_per_rank": [
                   rk["models"][name]["launches"]["panel_qr"]
                   for rk in ranks]}
        for key, val in got.items():
            if key in ("ms", "launches"):
                continue
            if isinstance(val, torch.Tensor):
                row[f"{key}_rel_vs_single_card"] = rel(val, single[key])
                row[f"{key}_same_on_every_rank"] = all(
                    torch.equal(rk["models"][name][key], val)
                    for rk in ranks)
            else:
                row[key] = val
                row[f"{key}_single_card"] = single[key]
        ok = all(row[k] for k in row if k.endswith("_same_on_every_rank"))
        ok = ok and all(row[k] < MODEL_DIST_TOL.get(name, MODEL_TOL)
                        for k in row if k.endswith("_rel_vs_single_card"))
        ok = ok and MODEL_GATES[name](got)
        row["ok"] = bool(ok)
        if not ok:
            failures.append(f"models.{name}")
        models_rows[name] = row

    grads = {}
    for name, g_ref in ref_grads.items():
        g = torch.cat([rk["grads"][name] for rk in ranks])
        grads[name] = rel(g, g_ref)
        if not grads[name] <= GRAD_TOL:
            failures.append(f"grad {name}")
    nccl_rows = {}
    for name in ("dqr_auto", "dtsqr"):
        resid, orth = nccl[name]["metrics"]
        a0 = dist_h.driver_input("a", seed, 0)
        q1, r1 = tsqr_tpu_torch.tsqr(a0, MODE)
        nccl_rows[name] = {"residual": resid, "orthogonality": orth,
                           "tier": nccl[name]["tier"], "ms": nccl[name]["ms"],
                           "wire": nccl[name]["wire"],
                           "r_rel_vs_single_card": rel(
                               sign_fixed(nccl[name]["r"], r1.float().cpu()),
                               r1.float().cpu())}
        del a0, q1, r1
        if not (resid < DIST_TOL and orth < DIST_TOL
                and nccl_rows[name]["r_rel_vs_single_card"] <= DIST_TOL):
            failures.append(f"nccl {name}")
    staged = sum(row["wire"]["host_staged"] for row in drivers.values())
    launches = {k: [rk["launches"][k] for rk in ranks]
                for k in set().union(*(rk["launches"] for rk in ranks))}
    line = {"distributed": {
        "backend": backend, "world": DIST_WORLD,
        "card": torch.cuda.get_device_name(0),
        "shape": f"({DIST_WORLD} x {dist_h.M_RANK}, {N}) f32 {MODE}",
        "gates": {"orthogonality_residual": DIST_TOL,
                  "r_vs_single_card": "core/auto.py _TOL of the mode",
                  "grad": GRAD_TOL,
                  "models": "MODEL_GATES, and MODEL_DIST_TOL (else "
                            "MODEL_TOL) against the single card"},
        "drivers": drivers, "models": models_rows,
        "grad_rel_vs_single_card": grads, "nccl_one_rank": {
            "backend": nccl["backend"], **nccl_rows},
        "host_staged_payloads": staged, "launches_per_rank": launches,
        "seconds": {"single_card_refs": t_ref,
                    "single_card_driver_refs": t_drivers,
                    "ranks": t_ranks,
                    "phase": time.perf_counter() - t0},
        "gates_passed": not failures, "failed": failures}}
    print(json.dumps(line), flush=True)
    if failures:
        raise AssertionError(f"distributed phase: {failures}")
    if min(launches["panel_qr"]) < 1:
        raise AssertionError(f"distributed path launches {launches}")
    return launches


def phase_native() -> None:
    """The native emulation cores (utils/native.py, g++) against the
    port's emulation products on the card: clip_mantissa bitwise, the
    three GEMMs at tests/test_native_emu.py's tolerances."""
    t0 = time.perf_counter()
    native._load()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    xs = rng.uniform(-4, 4, 256).astype(np.float32)
    out = {"library": str(native.library_path().name), "build_s": build_s}
    for bits in (7, 10):
        card = modes.clip_mantissa(torch.from_numpy(xs).cuda(), bits).cpu()
        cpp = np.array([native.clip_mantissa_scalar(float(x), bits)
                        for x in xs], np.float32)
        out[f"clip_{bits}_bitwise"] = bool(np.array_equal(card.numpy(), cpp))
    a = rng.uniform(-1, 1, (32, 48)).astype(np.float32)
    b = rng.uniform(-1, 1, (48, 24)).astype(np.float32)
    ta, tb = torch.from_numpy(a).cuda(), torch.from_numpy(b).cuda()
    gemms = {"nocor": (native.emu_gemm_nocor, modes.mm_bf16_nocor_emu, 1e-4),
             "cor": (native.emu_gemm_cor, modes.mm_bf16x3_cor_emu, 1e-5),
             "mixed": (native.emu_gemm_mixed, modes.mm_mixed_cor_emu, 1e-5)}
    for name, (cpp, emu, tol) in gemms.items():
        err = float(np.max(np.abs(cpp(a, b, bits=7)
                                  - emu(ta, tb).cpu().numpy())))
        out[f"{name}_max_abs_diff"] = err
        out[f"{name}_ok"] = err < tol
    print(json.dumps({"native": out}), flush=True)
    if not all(v for k, v in out.items() if k.endswith(("_ok", "bitwise"))):
        raise AssertionError(f"native phase: {out}")


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
            "launches": (tier4["counts"]["panel_qr"]
                         - tier4["cluster_launches"]),
            "max_abs_err": err,
            "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"], "library_ms": lib_ms,
            "shapes": f"({bs}, {L}, {N}) f32 {MODE} leaves of the tier-4 "
                      "path; launches are that path's on a CTA a tile "
                      "(panel_qr_cluster counts the rest); library_ms is "
                      "batched torch.linalg.qr",
            "other_modes_ms": mode_ms}


def panel_cluster_entry(tier4: dict, gen) -> dict:
    """panel_qr.cu's cluster path at a tree level's shapes, (B, 256, 128)
    bf16x6_cor for B in PANEL_LEVEL_BATCHES (block8192.well's levels take
    64 ... 1): each launch on clusters (the counter rises), held to the
    plain version at PANEL_TOL and timed beside one CTA a tile, the plain
    version and batched torch.linalg.qr, with its bound; launches from
    the tier-4 path, whose levels of 64 ... 1 nodes take the path."""
    md = gs._mode(MODE)
    rows = {}
    for b in PANEL_LEVEL_BATCHES:
        nodes = torch.rand(b, 2 * N, N, device="cuda", generator=gen) * 2 - 1
        nodes[:, :, ZERO_COL] = 0.0
        before = trace.counts("panel_qr.")["cluster_launches"]
        err = compare_panel(nodes, MODE, f"panel_qr_cluster ({b}, {2 * N}, "
                            f"{N})")
        if trace.counts("panel_qr.")["cluster_launches"] != before + 1:
            raise AssertionError(f"({b}, {2 * N}, {N}) took no cluster")
        k = pk._launch_cluster_size(b, 2 * N, N, gs._kernel_code(md))
        # a launch is ~0.2 ms: 20 back to back between two events, so the
        # host's launch cost stays out of the time
        ms, one_cta_ms = (float(np.median(timing.time_cuda(
            lambda kk=kk: [pk._panel_kernel(nodes, md, kk)
                           for _ in range(20)], reps=7, warmup=2))) / 20
            for kk in (k, 1))
        p_ms = float(np.median(timing.time_cuda(
            lambda: pk.panel_qr_reference(nodes, MODE), reps=2, warmup=1)))
        lib_ms = float(np.median(timing.time_cuda(
            lambda: torch.linalg.qr(nodes), reps=3, warmup=1)))
        bound = flops.panel_bound(b, 2 * N, N, MODE)
        rows[b] = {"cluster": k, "max_abs_err": err, "ms": ms,
                   "one_cta_ms": one_cta_ms, "plain_ms": p_ms,
                   "bound_ms": bound["bound_ms"],
                   "bound_by": bound["bound_by"], "library_ms": lib_ms}
    first = rows[PANEL_LEVEL_BATCHES[0]]
    return {"name": "panel_qr_cluster", "route": "cuda",
            "source": PANEL_SOURCE,
            "replaces": "tsqr_tpu/ops/pallas_panel_sb.py:149 (B2) at a "
                        "tree level's few nodes",
            "launches": tier4["cluster_launches"],
            "max_abs_err": max(x["max_abs_err"] for x in rows.values()),
            **{k: first[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
            "shapes": f"({PANEL_LEVEL_BATCHES[0]}, {2 * N}, {N}) f32 {MODE} "
                      "tree-level nodes with a zero column (by_batch: each "
                      "batch, one_cta_ms the same nodes on a CTA a tile; "
                      "ms and one_cta_ms a launch of 20 timed together); "
                      "launches are the tier-4 path's on clusters; "
                      "library_ms is batched torch.linalg.qr",
            "by_batch": rows}


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


def launches_by_path(bench_run: dict, ooc_run: dict, models_run: dict,
                     dist_run: dict, wide_run: dict,
                     panel_wide_run: dict) -> dict:
    """{path: {kernel: launches}} of the bench, wide, ooc, models and
    distributed phases, each path's counts set to 0 just before its first
    call and read just after; the bench's its whole child process, the
    distributed path's a list, one count a rank."""
    paths = {"bench": bench_run["launches"], "wide": wide_run["counts"],
             **panel_wide_run["paths"]}
    paths.update({("models." if k.startswith("lstsq") else "ooc.qr_regen ")
                  + k: v["launches"]
                  for k, v in ooc_run["regen"].items() if "launches" in v})
    paths["ooc.qr_out_of_core"] = ooc_run["host"]["launches"]
    paths.update({f"models.{k}": v["launches"]
                  for k, v in models_run["rows"].items()})
    paths["distributed"] = dist_run
    return paths


def wide_entries(wide: dict) -> list:
    """The wide kernels' entries: each held to its plain version and
    timed at the wide path's shape, (2^19, 512) bf16x6_cor, and at
    (2^18, 1024); launches from the wide path's run."""
    main = f"{M_WIDE_LADDER}x{N_WIDE}"
    other = f"{M_WIDE_CQR3}x{N_WIDE_CQR3}"
    out = []
    for name, call, lib in (("stream_wide_gram", "gram", "a.T@a"),
                            ("stream_wide_dot", "qpass", "a@rinv")):
        t = wide["times"][main][call]
        entry = {"name": name, "route": "cuda", "source": WIDE_SOURCE,
                 "replaces": "tsqr_tpu/ops/pallas_gram.py:196 (its range "
                             "128 < n <= 1024 or 2048; pallas_call at "
                             ":312)",
                 "launches": wide["counts"][name],
                 **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms",
                                      "bound_ms", "bound_by",
                                      "library_ms")},
                 "design_bound_ms": t["design_bound_ms"],
                 "design_bound_by": t["design_bound_by"],
                 "shapes": f"the {call} call at ({M_WIDE_LADDER}, {N_WIDE}) "
                           f"f32 {MODE}, as the wide path's tier "
                           f"{0 if call == 'gram' else 1} makes it (one "
                           f"launch a row chunk); library_ms is {lib}",
                 f"at_{other}": wide["times"][other][call],
                 "check_max_abs_err": {k: max(v.values())
                                       for k, v in wide["errs"].items()}}
        if name == "stream_wide_dot":
            entry["store_launches"] = wide["counts"]["stream_wide_store"]
            entry["split_r_launches"] = wide["counts"]["stream_wide_split_r"]
        entry["split_x_launches"] = wide["counts"]["stream_wide_split_x"]
        out.append(entry)
    fp32_shape = f"({M_WIDE_FP32}, {N_WIDE_FP32}) f32 fp32"
    for name, call, lib in (("stream_wide_gram_fp32", "gram", "a.T@a"),
                            ("stream_wide_dot_fp32", "qpass", "a@rinv")):
        t = wide["times_fp32"][call]
        out.append({
            "name": name, "route": "cuda", "source": WIDE_SOURCE,
            "replaces": "tsqr_tpu/ops/pallas_gram.py:196 (its fp32 mode, "
                        "128 < n <= 2048; pallas_call at :312)",
            "launches": wide["fp32_counts"][name],
            **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                 "bound_by", "library_ms")},
            "design_bound_ms": t["design_bound_ms"],
            "design_bound_by": t["design_bound_by"],
            "shapes": f"the {call} call at {fp32_shape}, as the wide fp32 "
                      f"path (cholqr3_fused compact) makes it; launches "
                      f"from that path; library_ms is {lib} in float32"})
    return out


def phase_kernels_line(a, counts, gen, tier4: dict, bw_run: dict,
                       inplace: dict, paths: dict, wide: dict,
                       panel_wide_entry: dict, split_mm_run: dict) -> None:
    """Every kernel of the main paths at the main paths' shapes: its time,
    its plain version's time, the library call's time and the bound; the
    stream and panel kernels' launches on the bench, ooc and models paths
    beside the main path's."""
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
        panel_cluster_entry(tier4, gen),
        panel_wide_entry,
        split_mm_entry(split_mm_run, tier4, paths),
        probe_entry("read_reduce", bw_run["counts"], gen),
        probe_entry("copy", bw_run["counts"], gen),
    ]
    kernels[4:4] = wide_entries(wide)
    for entry in kernels:
        if all(entry["name"] in c for c in paths.values()):
            entry["launches_by_path"] = {p: c[entry["name"]]
                                         for p, c in paths.items()}
    print(json.dumps({"kernels": kernels}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume-child", metavar="DIR",
                    help=argparse.SUPPRESS)  # the ooc phase's child
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.resume_child:
        return resume_child(args.resume_child)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    phase_card()
    phase_build()
    phase_kernel_vs_plain(gen)
    phase_panel_vs_plain(gen)
    phase_bw_vs_plain(gen)
    main_run = phase_main(gen)
    bench_run = phase_bench(main_run)
    tier4 = phase_tier4(gen)
    phase_tiers(args.seed)
    phase_qr_wide(gen)
    wide_run = phase_wide(gen)
    panel_wide_run = phase_panel_wide(gen)
    split_mm_run = phase_split_mm(gen)
    bw_run = phase_bw_sweep()
    inplace = phase_inplace(gen)
    phase_cholqr2(main_run["a"])
    phase_mfu()
    phase_qr_auto(gen)
    phase_grad(gen)
    phase_gram_error(main_run["a"])
    phase_update(args.seed)
    phase_harness(args.seed)
    phase_profile(tier4)
    ooc_run = phase_ooc()
    models_run = phase_models(args.seed)
    dist_run = phase_distributed(args.seed, ooc_run, models_run)
    phase_native()
    phase_kernels_line(main_run["a"], main_run["counts"], gen, tier4,
                       bw_run, inplace,
                       launches_by_path(bench_run, ooc_run, models_run,
                                        dist_run, wide_run, panel_wide_run),
                       wide_run, panel_wide_run["entry"], split_mm_run)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
