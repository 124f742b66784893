"""panel_wide_roofline: the wide panel kernel's (``panel_wide.cu``,
128 < n <= 512) share of its roofline.

Every call of ``ops/panel_kernel.panel_qr_batched`` is a span; the calls
on tiles wider than 128 columns (the TSQR tree's leaves and inner levels
at such an n) are kept.  Each one's bound is ``arith.panel_bound`` of
its (batch, L, n) tiles and mode.  The share is the sum of the bounds
over the device time (the union of the intervals) of the operations
launched inside those spans, whatever their names.

The harness's own span on the function, as ``panel_kernel_roofline``
reads it, and not the program's ``panel`` span: it records the mode,
which the bound needs and the program's span does not carry, and it
reads the same on a program that has no ``panel`` span."""

from qrbench import arith

SPANS = ["tsqr_tpu_torch.ops.panel_kernel:panel_qr_batched"]
KEY = "tsqr_tpu_torch.ops.panel_kernel.panel_qr_batched"
N_NARROW = 128   # widest n of panel_qr.cu


def read(view):
    if view.trace is None:
        return None
    spans = [s for s in view.spans.outermost(KEY)
             if s.args["a"]["shape"][2] > N_NARROW]
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
