"""Faults planted under BlockQR's panel steps (the ``block8192`` cell's
path), for ``run.py --prepare qrbench.tests.faults_blockqr:<name>``.
As in ``faults.py``, each replaces a module attribute of the program for
the rest of the process; the program's files are never edited."""

from __future__ import annotations


def _projections_at(mm_name: str):
    """Every projection product of every CGS pass at ``modes.<mm_name>``
    in place of the mode's ``trailing_mm`` (float32)."""
    from tsqr_tpu_torch import modes
    from tsqr_tpu_torch.core import blockqr

    project = blockqr._project
    low = getattr(modes, mm_name)

    def broken(mm, qp, x, reduce):
        return project(low, qp, x, reduce)
    blockqr._project = broken


def project_bf16():
    """The projections at one bf16 part (``modes.mm_bf16``)."""
    _projections_at("mm_bf16")


def project_tf32():
    """The projections in TF32 (``modes.mm_tf32_nocor_emu``: operands cut
    to TF32's 10 mantissa bits, float32 sums), as a float32 product on
    the card's tensor cores would run with TF32 allowed."""
    _projections_at("mm_tf32_nocor_emu")


def second_pass_dropped():
    """CGS2's second pass (its projection and second factorization)
    dropped on the panel at column 128: that panel is CGS1.  On the
    ``well`` mix (kappa ~ 1) one float32 projection is already
    orthogonal to float32 grade, so this run reads correct, at full
    size on the card as on the CPU (PERF.md, section 2): no test holds
    it to not correct."""
    from tsqr_tpu_torch.core import blockqr

    step = blockqr._panel_step

    def broken(q, r, a_b, c0, mm, tsqr_fn, reorth, *args, **kwargs):
        return step(q, r, a_b, c0, mm, tsqr_fn, reorth and c0 != 128,
                    *args, **kwargs)
    blockqr._panel_step = broken
