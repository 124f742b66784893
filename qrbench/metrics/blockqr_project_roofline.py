"""blockqr_project_roofline: BlockQR's projection products' share of
their roofline.

Every call of ``core/blockqr._project`` (one CGS pass's two products
against the Q built so far: S = Q^T X and X - Q S) is a span of the
harness.  Each product's bound is ``arith.bound`` of its bytes and
operations: each operand read once and the output written once (Q
(m, c) and X (m, w) read, S (c, w) written; Q, S and X read, (m, w)
written), 2 m c w flops at the cell's mode's ``DOT_PRODUCTS`` bf16
products, or in float32 for ``fp32``, as ``arith.panel_bound`` counts a
panel's.  That is the least time any implementation of the mode could
take, whatever carries the products (float32 cuBLAS today).  The share
is the sum of the bounds over the device time (the union of the
intervals) of the operations launched inside those spans, whatever
their names.

A program without ``_project`` (before the function existed) gets no
span target, and the metric reads None there."""

import importlib

from qrbench import arith

MODULE = "tsqr_tpu_torch.core.blockqr"
KEY = MODULE + "._project"


def _targets() -> list:
    try:
        mod = importlib.import_module(MODULE)
    except ImportError:
        return []
    return [MODULE + ":_project"] if callable(getattr(mod, "_project", None)) \
        else []


SPANS = _targets()


def pass_bound_ms(m: int, c: int, w: int, mode: str) -> float:
    """The two products' bounds of one pass, Q (m, c) against X (m, w)."""
    flops = 2.0 * m * c * w * arith.DOT_PRODUCTS[mode]
    bf16, fp32 = (0.0, flops) if mode == "fp32" else (flops, 0.0)
    qtx = arith.bound(4.0 * (m * c + m * w + c * w), bf16, fp32)
    update = arith.bound(4.0 * (m * c + c * w + 2 * m * w), bf16, fp32)
    return qtx["bound_ms"] + update["bound_ms"]


def read(view):
    if view.trace is None:
        return None
    spans = view.spans.outermost(KEY)
    launched = view.trace.ops_in([s.sid for s in spans])
    ops = [op for sid in launched for op in launched[sid]]
    device_s = view.trace.busy_s(ops)
    if not ops or device_s <= 0:
        return None
    mode = view.cell.config["mode"]
    bound_ms = 0.0
    for s in spans:
        if launched.get(s.sid):
            m, c = s.args["qp"]["shape"]
            w = s.args["x"]["shape"][1]
            bound_ms += pass_bound_ms(m, c, w, mode)
    return 100.0 * bound_ms / 1e3 / device_s
