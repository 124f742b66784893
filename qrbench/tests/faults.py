"""Faults planted under the timed path, for the tests that see ``correct``
come out false.  Each is a function for ``run.py --prepare
qrbench.tests.faults:<name>``, called first in every process of a run;
it replaces a module attribute of the program for the rest of the
process (the program's files are never edited).
"""

from __future__ import annotations

import torch


def _patch(module, attr: str, make):
    setattr(module, attr, make(getattr(module, attr)))


def _tier1_q(fix):
    """Apply ``fix(q, a)`` to the Q that a stream pass writes."""
    from tsqr_tpu_torch.ops import gram_stream

    def make(stream):
        def broken(a, *args, **kwargs):
            out = stream(a, *args, **kwargs)
            if not kwargs.get("write_q", len(args) > 2 and args[2]):
                return out
            if isinstance(out, tuple):
                return (fix(out[0], a),) + out[1:]
            return fix(out, a)
        return broken
    _patch(gram_stream, "stream", make)


def q_unchanged():
    """Tier 1: the Q pass returns its input unchanged."""
    _tier1_q(lambda q, a: a.to(q.dtype).clone())


def q_row_altered():
    """Tier 1: one row of Q altered (its sign flipped) where the pass
    produces it."""
    def fix(q, a):
        q = q.clone()
        q[7] = -q[7]
        return q
    _tier1_q(fix)


def gram_half_rows():
    """Tier 0: the Gram of half the rows, doubled (half of the batch left
    out, the mean taken over the rest)."""
    from tsqr_tpu_torch.ops import gram_stream

    def make(gram):
        def broken(a, *args, **kwargs):
            return 2.0 * gram(a[: a.shape[0] // 2], *args, **kwargs)
        return broken
    _patch(gram_stream, "gram_stream", make)


def tree_unchanged():
    """Tier 4: each TSQR tree returns its panel unchanged, R = I."""
    from tsqr_tpu_torch.core import tsqr as tsqr_mod

    def make(tsqr):
        def broken(a, *args, **kwargs):
            n = a.shape[1]
            return a.clone(), torch.eye(n, dtype=a.dtype, device=a.device)
        return broken
    _patch(tsqr_mod, "tsqr", make)


def leaves_half():
    """Tier 4: the tree's leaf QR on the first half of the leaves only,
    its factors copied over the other half."""
    from tsqr_tpu_torch.ops import panel_kernel

    def make(batched):
        def broken(a, *args, **kwargs):
            half = max(a.shape[0] // 2, 1)
            qt, r = batched(a[:half], *args, **kwargs)
            reps = -(-a.shape[0] // half)
            return (qt.repeat(reps, 1, 1)[: a.shape[0]],
                    r.repeat(reps, 1, 1)[: a.shape[0]])
        return broken
    _patch(panel_kernel, "panel_qr_batched", make)


def tree_row_altered():
    """Tier 4: one row of a tree's Q altered (0.01 added) where the tree
    produces it.  (A flipped sign would cancel: CGS2 factors each panel
    twice, and two flips of one row are none.)"""
    from tsqr_tpu_torch.core import tsqr as tsqr_mod

    def make(tsqr):
        def broken(*args, **kwargs):
            q, r = tsqr(*args, **kwargs)
            q = q.clone()
            q[7] += 0.01
            return q, r
        return broken
    _patch(tsqr_mod, "tsqr", make)


def no_exchange():
    """Several ranks: the sum over the ranks left out (each rank keeps its
    own Gram)."""
    from tsqr_tpu_torch.parallel import comm
    _patch(comm, "psum", lambda psum: (lambda x, mesh, axis: x.clone()))


def dist_gram_half_rows():
    """Several ranks: each rank's Gram of half its rows, doubled."""
    from tsqr_tpu_torch import modes

    def make(gram):
        def broken(a, policy):
            return 2.0 * gram(a[: a.shape[0] // 2], policy)
        return broken
    _patch(modes, "gram", make)


def dist_q_unchanged():
    """Several ranks: ``dqr_auto`` returns each rank's rows unchanged as
    its Q."""
    from tsqr_tpu_torch.parallel import dtsqr

    def make(shard):
        def broken(a, *args, **kwargs):
            q, r, tier, k2 = shard(a, *args, **kwargs)
            return a.clone(), r, tier, k2
        return broken
    _patch(dtsqr, "_dqr_auto_shard", make)


def dist_q_row_altered():
    """Several ranks: one row of rank 0's Q altered where ``dqr_auto``
    produces it."""
    import torch.distributed as dist

    from tsqr_tpu_torch.parallel import dtsqr

    def make(shard):
        def broken(a, *args, **kwargs):
            q, r, tier, k2 = shard(a, *args, **kwargs)
            if dist.get_rank() == 0:
                q = q.clone()
                q[7] = -q[7]
            return q, r, tier, k2
        return broken
    _patch(dtsqr, "_dqr_auto_shard", make)
