"""Float32 accuracy of the card's library calls that the beyond-memory QR
and the models lean on, against float64 on the same card.

* the small SVD (``torch.linalg.svd`` of the (128, 128) R of a uniform
  (2^16, 128) input, R from ``fastqr(..., "cholqr3_fused")``) per
  cuSOLVER driver, in float32 and in float64 rounded to float32: U's
  orthogonality and the singular values' largest relative error (why
  ``models._common.svd`` runs float64 on the card);
* the Gram of a uniform (m, 128) float32 A, in one product and in
  ``ooc.GRAM_BLOCK``-row blocks (``ooc._gram``), per mode, and the
  product of A's leading bf16 split part with itself: relative error
  against the float64 Gram (why ``ooc._gram`` sums blocks in float64,
  and what remains);
* ``ooc.qr_regen`` ``cholqr2`` at (m, 128) from ``ooc.uniform_gen``, Q
  formed chunk by chunk from ``info["rinv"]``: Q's orthogonality per
  mode.

Prints one JSON line with the card's name and power limit:

    python -m tsqr_tpu_torch.harness.precision [--m 4194304]

Raises without a card: a float32 accuracy of the CPU's BLAS says nothing
of the card's.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import cholqr, ooc
from tsqr_tpu_torch.utils import validation

N = 128
DRIVERS = (None, "gesvdj", "gesvd", "gesvda")


def _rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float(torch.linalg.norm(x.double() - ref) / torch.linalg.norm(ref))


def small_svd(gen: torch.Generator) -> dict:
    a = torch.rand(1 << 16, N, device="cuda", generator=gen) * 2 - 1
    _, r = cholqr.fastqr(a, "bf16x6_cor", method="cholqr3_fused")
    s64 = torch.linalg.svdvals(r.double())
    out = {}
    for dtype in (torch.float32, torch.float64):
        for drv in DRIVERS if dtype == torch.float32 else (None, "gesvd"):
            u, s, _ = torch.linalg.svd(r.to(dtype), full_matrices=False,
                                       driver=drv)
            out[f"{str(dtype)[6:]} {drv or 'default'}"] = {
                "u_orthogonality": validation.orthogonality_accurate(
                    u.float()),
                "s_max_rel_err": float(((s.float().double() - s64).abs()
                                        / s64).max())}
    return out


def gram_forms(m: int, gen: torch.Generator) -> dict:
    a = torch.rand(m, N, device="cuda", generator=gen) * 2 - 1
    g64 = a.double().T @ a.double()
    out = {}
    for mode in ("fp32", "bf16x3_cor", "bf16x6_cor"):
        p = modes.resolve(mode)
        out[mode] = {"one_product": _rel(modes.gram(a, p), g64),
                     "blocks": _rel(ooc._gram(a, p), g64)}
    a0 = modes.split3(a)[0]
    out["bf16 part a0^T a0"] = _rel(a0.T @ a0, a0.double().T @ a0.double())
    return out


def regen_q(m: int, chunk: int) -> dict:
    gen = ooc.uniform_gen(7, chunk, N, dtype=torch.float32)
    out = {}
    for mode in ("fp32", "bf16x6_cor"):
        _, info = ooc.qr_regen(gen, m, N, mode, "cholqr2", chunk)
        q = torch.cat([modes.mm_fp32(gen(i), info["rinv"])
                       for i in range(m // chunk)])
        out[mode] = validation.orthogonality_accurate(q)
    return out


def run(m: int = 1 << 22, chunk: int = 1 << 21, seed: int = 0) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("harness.precision measures the CUDA card's "
                           "float32 calls; no card is available")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return {"small_svd_128": small_svd(gen),
            f"gram_rel_err_{m}x{N}": gram_forms(m, gen),
            f"regen_q_orthogonality_{m}x{N}": regen_q(m, chunk)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--m", type=int, default=1 << 22)
    ap.add_argument("--chunk", type=int, default=1 << 21)
    args = ap.parse_args()
    out = run(args.m, args.chunk)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"precision": out, "card": card}), flush=True)


if __name__ == "__main__":
    main()
