"""tsqr.q_build_device_ms_per_tree: the device time of a TSQR tree's Q
build, read as ``tsqr.levels_device_ms_per_tree`` is, over the program's
``tsqr.q_build`` spans: the products that carry Q down the tree at the
mode, a tree's last phase."""

from qrbench import cell as _cell

_base = _cell.load_metric("tsqr.levels_device_ms_per_tree")
SPANS = _base.SPANS


def read(view):
    return _base.device_ms_per_tree(view, "tsqr.q_build")
