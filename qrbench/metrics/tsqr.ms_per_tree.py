"""tsqr.ms_per_tree: host time of a TSQR tree, ``core/tsqr.tsqr``'s
span (entry to return) averaged over the trees of the traced window."""

SPANS = ["tsqr_tpu_torch.core.tsqr:tsqr"]
KEY = "tsqr_tpu_torch.core.tsqr.tsqr"


def read(view):
    trees = view.spans.outermost(KEY)
    if not trees:
        return None
    return 1e3 * sum(s.seconds for s in trees) / len(trees)
