"""The collectives of the distributed layer, one named function each.

The JAX package's ``lax.psum``, ``all_gather(..., tiled=True)``,
``ppermute`` and ``axis_index`` become explicit ``torch.distributed``
calls on the process group of a mesh axis (``parallel/mesh.py``).  An
axis is a mesh axis name or a tuple of them (the flattened row axis of a
2-D mesh).

Backends.  NCCL moves CUDA tensors between cards.  Gloo moves host
memory: under gloo a CUDA payload is copied to the host, reduced or sent
there, and copied back (:data:`HOST_STAGED`); every such copy is counted.
Several ranks on one card run over gloo, since NCCL takes one rank a
card.  Nothing here catches an error and retries another way.

Every call records its op, its payload bytes and whether it was staged
through the host into each open :func:`counting` context: the wire
counter the tests and ``chip_smoke.py`` read.  Bytes are the collective's
result array, as the JAX package's HLO scan counts them: an all-gather
counts its gathered (D n, n), an all-reduce and an exchange their
(n, n).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.distributed as dist

Tensor = torch.Tensor

# backends whose collectives run in host memory: a CUDA payload is
# staged through the host, explicitly and counted
HOST_STAGED = frozenset({"gloo"})


@dataclasses.dataclass
class Wire:
    """What the collectives of a :func:`counting` block moved:
    ``ops[op] = [calls, bytes]`` and ``staged[op]``, the payloads copied
    through host memory."""

    ops: dict = dataclasses.field(default_factory=dict)
    staged: dict = dataclasses.field(default_factory=dict)

    def add(self, op: str, nbytes: int, staged: bool) -> None:
        entry = self.ops.setdefault(op, [0, 0])
        entry[0] += 1
        entry[1] += nbytes
        if staged:
            self.staged[op] = self.staged.get(op, 0) + 1

    @property
    def host_staged(self) -> int:
        return sum(self.staged.values())

    def as_dict(self) -> dict:
        return {"ops": {k: {"calls": c, "bytes": b}
                        for k, (c, b) in self.ops.items()},
                "host_staged": self.host_staged}


_OPEN: list[Wire] = []


@contextlib.contextmanager
def counting():
    """Count the collectives this process runs inside the block:
    ``with comm.counting() as wire: ...``."""
    wire = Wire()
    _OPEN.append(wire)
    try:
        yield wire
    finally:
        _OPEN.remove(wire)


def _record(op: str, nbytes: int, staged: bool) -> None:
    for wire in _OPEN:
        wire.add(op, nbytes, staged)


def _nbytes(x: Tensor) -> int:
    return x.numel() * x.element_size()


def backend(mesh, axis) -> str:
    return str(dist.get_backend(mesh.get_group(axis)))


def _staging(x: Tensor, mesh, axis) -> bool:
    return x.is_cuda and backend(mesh, axis) in HOST_STAGED


def axes_size(mesh, axis) -> int:
    """Ranks along ``axis`` (the product over a tuple of axes)."""
    names = axis if isinstance(axis, tuple) else (axis,)
    size = 1
    for name in names:
        size *= mesh.shape[name]
    return size


def linear_index(mesh, axis) -> int:
    """This rank's position along ``axis``: row-major over a tuple of
    axes, the order of the JAX package's ``P((a, b))`` shards and of an
    all-gather over the same tuple (``dtsqr._linear_index``)."""
    names = axis if isinstance(axis, tuple) else (axis,)
    idx = 0
    for name in names:
        idx = idx * mesh.shape[name] + mesh.coords[
            mesh.axis_names.index(name)]
    return idx


def _all_reduce(x: Tensor, mesh, axis) -> Tensor:
    group = mesh.get_group(axis)
    staged = _staging(x, mesh, axis)
    out = x.detach().to("cpu" if staged else x.device, copy=True)
    out = out.contiguous()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    _record("psum", _nbytes(out), staged)
    return out.to(x.device) if staged else out


class _PSum(torch.autograd.Function):
    """The sum over ranks under autograd: with the global loss the sum
    of the ranks' losses, each rank's x gets the sum of the ranks'
    cotangents of the (replicated) sum."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axis), None, None


def psum(x: Tensor, mesh, axis) -> Tensor:
    """Sum of ``x`` over the ranks of ``axis`` (``lax.psum``), as a new
    tensor on every rank; differentiable (its backward is a sum too)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _PSum.apply(x, mesh, axis)
    return _all_reduce(x, mesh, axis)


def reducer(mesh, axis):
    """``psum`` over ``axis`` as a one-argument function: the ``reduce``
    hook of ``core.blockqr._panel_step``, ``core.ooc._regen_body`` and the
    distributed gradient rule."""
    return lambda x: psum(x, mesh, axis)


def all_gather_rows(x: Tensor, mesh, axis) -> Tensor:
    """The ranks' ``x`` stacked along rows in rank order: (D rows, ...),
    the JAX package's ``all_gather(x, axis, axis=0, tiled=True)``."""
    group = mesh.get_group(axis)
    d = axes_size(mesh, axis)
    staged = _staging(x, mesh, axis)
    src = x.detach().to("cpu" if staged else x.device).contiguous()
    out = src.new_empty((d * src.shape[0], *src.shape[1:]))
    dist.all_gather(list(out.chunk(d)), src, group=group)
    _record("all_gather", _nbytes(out), staged)
    return out.to(x.device) if staged else out


def exchange(x: Tensor, partner: int, mesh, axis) -> Tensor:
    """Swap ``x`` with the rank at position ``partner`` along ``axis`` and
    return the partner's (``lax.ppermute`` over a pairing), by one
    ``batch_isend_irecv`` of a send and a receive."""
    group = mesh.get_group(axis)
    peer = mesh.group_ranks(axis)[partner]
    staged = _staging(x, mesh, axis)
    src = x.detach().to("cpu" if staged else x.device).contiguous()
    buf = torch.empty_like(src)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, src, peer, group),
        dist.P2POp(dist.irecv, buf, peer, group)])
    for req in reqs:
        req.wait()
    _record("exchange", _nbytes(buf), staged)
    return buf.to(x.device) if staged else buf


def all_min(values, mesh, axis) -> list[int]:
    """Elementwise minimum over the ranks of ``axis`` of a few host
    integers, in one all-reduce (on the card under NCCL, in host memory
    under gloo)."""
    group = mesh.get_group(axis)
    dev = "cuda" if backend(mesh, axis) == "nccl" else "cpu"
    t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    _record("agree", _nbytes(t), False)
    return t.tolist()


def agree(flag: bool, mesh, axis) -> bool:
    """A host decision that every rank of ``axis`` takes alike: True only
    if it is True on every rank.  Each branch that precedes a collective
    goes through it, so that no rank takes another branch and hangs the
    group in its next collective."""
    return bool(all_min([bool(flag)], mesh, axis)[0])
