"""blockqr.panels_device_ms_per_call: the device time of BlockQR's panel
factorizations (the TSQR trees of both CGS passes), read as
``blockqr.project_device_ms_per_call`` is, over the program's
``blockqr.panel`` spans.  A call's device time less these two is its
R fix-ups, copies into Q and R, and casts."""

from qrbench import cell as _cell

_base = _cell.load_metric("blockqr.project_device_ms_per_call")
SPANS = _base.SPANS


def read(view):
    return _base.device_ms_per_call(view, "blockqr.panel")
