"""Dry run of the seven distributed drivers on a group of spawned ranks.

    python -m tsqr_tpu_torch.parallel.dryrun WORLD [--device cpu]

Counterpart of the JAX package's multi-chip dry run: ``dqr`` with
reorthogonalization, ``dtsqr`` with both trees, ``dcholqr``,
``dqr_auto``, ``dqr_regen``, ``dtsqr_hier`` (on a (2, WORLD / 2) mesh)
and ``dsketch``, on a (64 WORLD, 32) uniform input.  Each rank holds its
rows; the parent prints one line per driver with the global residual
and orthogonality (float64 sums over the ranks) and fails if any is
off.  The ranks run on the cards, over NCCL with a card a rank and over
gloo when several share one; with ``--device cpu`` they run on the CPU
over gloo.
"""

from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from tsqr_tpu_torch.parallel import comm, dtsqr, launch
from tsqr_tpu_torch.parallel import mesh as mesh_mod

N = 32
RESID_MAX = 1e-3
ORTH_MAX = 1e-5


def metrics(a: torch.Tensor, q: torch.Tensor, r: torch.Tensor, mesh,
            axis=mesh_mod.ROWS_AXIS) -> tuple[float, float]:
    """(||A - QR||_F / ||A||_F, ||Q^T Q - I||_F / sqrt(n)) of a row-sharded
    factorization, from float64 sums over the ranks: the same numbers on
    every rank."""
    axis = mesh_mod.row_axes(mesh, axis)
    a64, q64, r64 = a.double(), q.double(), r.double()
    d = a64 - q64 @ r64
    sq = comm.psum(torch.stack([torch.sum(d * d), torch.sum(a64 * a64)]),
                   mesh, axis)
    g = comm.psum(q64.T @ q64, mesh, axis)
    n = q.shape[1]
    eye = torch.eye(n, dtype=torch.float64, device=g.device)
    return (float(torch.sqrt(sq[0] / sq[1])),
            float(torch.linalg.norm(g - eye)) / math.sqrt(n))


def _ranks(rank: int, world: int, device: str) -> list:
    """Every driver on this rank's rows; [(name, residual, orthogonality)]."""
    from tsqr_tpu_torch.core import ooc

    mesh = mesh_mod.make_mesh()
    m = 64 * world
    a_all = np.random.default_rng(1).uniform(-1, 1, (m, N)).astype(
        np.float32)
    a = torch.from_numpy(mesh_mod.row_shard(a_all, mesh)).to(device)
    kw = dict(device=device, leaf_rows=32)
    runs = [
        ("dqr[blockqr+reorth]", lambda: dtsqr.dqr(
            a, mesh, "bf16x6_cor", reorth=True, panel_width=16, **kw)),
        ("dtsqr[allgather]", lambda: dtsqr.dtsqr(
            a, mesh, "bf16x6_cor", tree="allgather", **kw)),
        ("dtsqr[butterfly]", lambda: dtsqr.dtsqr(
            a, mesh, "bf16x6_cor", tree="butterfly", **kw)),
        ("dcholqr[cholqr3]", lambda: dtsqr.dcholqr(
            a, mesh, "fp32", method="cholqr3", device=device)),
        ("dqr_auto[predictive-ladder]", lambda: dtsqr.dqr_auto(
            a, mesh, "fp32", **kw)),
    ]
    out = []
    for name, fn in runs:
        q, r = fn()
        out.append((name, *metrics(a, q, r, mesh)))
    # matrix-free: rank d makes its own chunks of the global generator
    chunk = m // (2 * world)
    gen = ooc.uniform_gen(2, chunk, N, dtype=torch.float32, device=device)
    _, info = dtsqr.dqr_regen(gen, m, N, mesh, "fp32", method="cholqr2",
                              chunk_rows=chunk, device=device)
    out.append(("dqr_regen[matrix-free]", float(info["residual"]),
                float(info["orthogonality"])))
    if world >= 2 and world % 2 == 0:
        mesh2 = mesh_mod.make_mesh2d(2, world // 2)
        a2 = torch.from_numpy(mesh_mod.row_shard(a_all, mesh2)).to(device)
        q, r = dtsqr.dtsqr_hier(a2, mesh2, "bf16x6_cor", **kw)
        out.append(("dtsqr_hier[ici+dcn]", *metrics(a2, q, r, mesh2)))
    # the sketch: a Gaussian embedding of A keeps ||B x|| ~ sqrt(l) ||A x||
    b = dtsqr.dsketch(a, 7, 4 * N, mesh, device=device)
    s_b = torch.linalg.svdvals(b.double().cpu()) / math.sqrt(4 * N)
    s_a = torch.from_numpy(np.linalg.svd(a_all.astype(np.float64),
                                         compute_uv=False))
    out.append(("dsketch[embedding]", float((s_b / s_a).max()),
                float((s_b / s_a).min())))
    return out


def run(world: int, device: str = "cuda", timeout: float = 300.0) -> list:
    """The dry run on ``world`` spawned ranks: rank 0's lines, each held
    to the gates (raises if one misses)."""
    rows = launch.spawn(world, _ranks, (device,), device=device,
                        timeout=timeout)
    for name, x, y in rows[0]:
        if name.startswith("dsketch"):
            ok = 0.2 < y <= x < 5.0
        else:
            ok = (math.isfinite(x) and x < RESID_MAX
                  and math.isfinite(y) and y < ORTH_MAX)
        if not ok:
            raise AssertionError(f"dryrun {name}: {x:.2e}, {y:.2e}")
    return rows[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("world", type=int)
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("dryrun: no CUDA device", file=sys.stderr)
            return 2
        from tsqr_tpu_torch.ops import _build
        _build.build(("panel_qr",))   # once, before the ranks load it
    backend = launch.pick_backend(args.world, args.device)
    for name, x, y in run(args.world, args.device):
        what = (f"singular value ratio max={x:.3f}, min={y:.3f}"
                if name.startswith("dsketch")
                else f"residual={x:.2e}, orthogonality={y:.2e}")
        print(f"dryrun({args.world}, {args.device}, {backend}) {name}: ok, "
              f"{what}", flush=True)
    print(f"dryrun({args.world}): ALL DRIVERS OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
