"""device.idle_share.wide: ``device.idle_share`` in the cells that report
``qr_tflops.wide``."""

from qrbench import cell as _cell

_base = _cell.load_metric("device.idle_share")
SPANS, AVERAGE, HOST_OPS, read = (_base.SPANS, _base.AVERAGE,
                                  _base.HOST_OPS, _base.read)
