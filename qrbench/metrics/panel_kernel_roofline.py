"""panel_kernel_roofline: the panel kernel's share of its roofline.

Every call of ``ops/panel_kernel.panel_qr_batched`` (the TSQR tree's
leaves) is a span; its bound is ``arith.panel_bound`` of the (batch, L,
n) tiles and the mode it was given.  The share is the sum of the bounds
over the device time (the union of the intervals) of the operations
launched inside those spans, whatever their names."""

from qrbench import arith

SPANS = ["tsqr_tpu_torch.ops.panel_kernel:panel_qr_batched"]
KEY = "tsqr_tpu_torch.ops.panel_kernel.panel_qr_batched"


def read(view):
    if view.trace is None:
        return None
    spans = view.spans.outermost(KEY)
    launched = view.trace.ops_in([s.sid for s in spans])
    ops = [op for sid in launched for op in launched[sid]]
    device_s = view.trace.busy_s(ops)
    if not ops or device_s <= 0:
        return None
    bound_ms = 0.0
    for s in spans:
        if launched.get(s.sid):
            batch, rows, n = s.args["a"]["shape"]
            bound_ms += arith.panel_bound(batch, rows, n,
                                          s.args["mode"])["bound_ms"]
    return 100.0 * bound_ms / 1e3 / device_s
