"""comm.ms_per_call: the collectives' device time a call, on rank 0:
the union of the intervals of the operations (NCCL's kernels, which
include the wait for the other ranks) launched inside the spans of
``parallel/comm``'s ``psum``, ``agree`` and ``all_gather_rows``, over
the traced calls."""

SPANS = ["tsqr_tpu_torch.parallel.comm:psum",
         "tsqr_tpu_torch.parallel.comm:agree",
         "tsqr_tpu_torch.parallel.comm:all_gather_rows"]
KEYS = [s.replace(":", ".") for s in SPANS]


def read(view):
    if view.trace is None or view.calls < 1:
        return None
    sids = [s.sid for key in KEYS for s in view.spans.outermost(key)]
    launched = view.trace.ops_in(sids)
    ops = [op for sid in launched for op in launched[sid]]
    if not ops:
        return None
    return 1e3 * view.trace.busy_s(ops) / view.calls
