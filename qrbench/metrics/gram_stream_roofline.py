"""gram_stream_roofline: the stream passes' share of their roofline.

Every call of ``ops/gram_stream.stream`` (the Gram passes of
``gram_stream.gram_stream`` and the Q passes of ``qpass_stream`` go
through it) is a span; its bound is ``arith.stream_bound`` of the
arguments it was given (A read once, the factors read once, Q and the
half-Gram written once, the products at the mode's count).  The share is
the sum of the bounds over the device time (the union of the intervals)
of the operations launched inside those spans, whatever their names."""

from qrbench import arith

SPANS = ["tsqr_tpu_torch.ops.gram_stream:stream"]
KEY = "tsqr_tpu_torch.ops.gram_stream.stream"


def _bound_ms(args: dict) -> float:
    a = args["a"]
    m, n = a["shape"]
    out = args.get("out_dtype") or a["dtype"]
    return arith.stream_bound(
        m, n, tuple(args.get("dot_modes") or ()), args.get("gram_mode"),
        bool(args.get("write_q")), arith.ITEM_BYTES[a["dtype"]],
        arith.ITEM_BYTES[out])["bound_ms"]


def read(view):
    if view.trace is None:
        return None
    spans = view.spans.outermost(KEY)
    launched = view.trace.ops_in([s.sid for s in spans])
    ops = [op for sid in launched for op in launched[sid]]
    device_s = view.trace.busy_s(ops)
    if not ops or device_s <= 0:
        return None
    bound_s = sum(_bound_ms(s.args) for s in spans if launched.get(s.sid)) / 1e3
    return 100.0 * bound_s / device_s
