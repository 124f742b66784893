"""ladder.self_ms_per_call: the ladder's own host time a call, in window
0 (no profiler): each outermost ``ladder`` span's length less the union
of its ``stream``, ``sync``, ``blockqr`` and ``tsqr.tree`` descendants
(the program's spans, ``qrbench/program_spans.py``), averaged over the
calls.  What is left is the ladder's host math between kernels (tier 0's
Cholesky, inverse and kappa^2 bound, the gates' products, the casts):
launches and allocations on the host, not the wait for the device,
which the ``sync`` spans hold."""

from qrbench import program_spans as ps

SPANS = []
EXCLUDED = ("stream", "sync", "blockqr", "tsqr.tree")


def read(view):
    calls = ps.window_calls(view)
    if not calls:
        return None
    return sum(ps.COLLECTOR.self_ns(c.sid, EXCLUDED) for c in calls) \
        / len(calls) / 1e6
