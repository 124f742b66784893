"""householder.ms_per_tree: host time of the tree's inner nodes, the
spans of ``ops/householder.blocked_householder_qr`` called inside a
``core/tsqr.tsqr`` span, summed and divided by the trees."""

SPANS = ["tsqr_tpu_torch.core.tsqr:tsqr",
         "tsqr_tpu_torch.ops.householder:blocked_householder_qr"]
TREE = "tsqr_tpu_torch.core.tsqr.tsqr"
NODE = "tsqr_tpu_torch.ops.householder.blocked_householder_qr"


def read(view):
    trees = view.spans.outermost(TREE)
    if not trees:
        return None
    nodes = [s for s in view.spans.outermost(NODE) if TREE in s.outer]
    return 1e3 * sum(s.seconds for s in nodes) / len(trees)
