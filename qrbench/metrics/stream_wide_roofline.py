"""stream_wide_roofline: the wide stream kernels' (``stream_wide.cu``,
128 < n) share of their roofline, read as ``gram_stream_roofline`` is:
the bounds of the ``ops/gram_stream.stream`` calls over the device time
launched inside them, in the cells that report ``qr_tflops.wide``."""

from qrbench import cell as _cell

_base = _cell.load_metric("gram_stream_roofline")
SPANS, read = _base.SPANS, _base.read
