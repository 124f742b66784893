"""Process meshes for the distributed TSQR/BlockQR layer.

Counterpart of ``tsqr_tpu/parallel/mesh.py``.  The JAX package shards a
global array over a mesh of devices and runs one program over it
(``shard_map``); here every rank is a process of a
``torch.distributed`` group that holds its own rows, and the collectives
are explicit (``parallel/comm.py``).  A :class:`Mesh` names the ranks'
layout: a 1-D ``("rows",)`` mesh (:func:`make_mesh`) or a 2-D
``("slices", "chips")`` mesh (:func:`make_mesh2d`) whose chip axis is
the fast interconnect inside a slice and whose slice axis is the slow
one across slices.  Ranks are slice-major (``rank = slice * chips +
chip``), the order of the JAX package's ``P((slices, chips))`` shards.

The mesh is a small class of its own rather than
``torch.distributed.device_mesh.DeviceMesh``: the port runs several
ranks on one card (over gloo), where ``DeviceMesh``'s placement of
ranks on devices does not apply, and it needs only the process group of
each axis and of the flattened row axis.

:func:`row_shard` and :func:`vec_shard` take the place of the JAX
package's ``row_sharding`` / ``vec_sharding``: they cut this rank's rows
out of a whole matrix, exactly the rows the JAX mesh's device of the
same index holds.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch.distributed as dist

from tsqr_tpu_torch.parallel import comm

ROWS_AXIS = "rows"
SLICE_AXIS = "slices"
CHIP_AXIS = "chips"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A layout of ranks with named axes, as this rank sees it.

    ``ranks`` holds the global ranks in mesh order (row-major over
    ``axis_names``); ``coords`` is this rank's coordinate on each axis,
    None for a rank outside the mesh; ``groups`` maps each axis name, and
    the tuple of all names (the flattened row axis), to the process group
    of this rank's line along it."""

    axis_names: tuple[str, ...]
    shape: dict[str, int]
    ranks: tuple[int, ...]
    coords: tuple[int, ...] | None
    groups: dict

    def get_group(self, axis) -> dist.ProcessGroup:
        return self.groups[axis]

    def group_ranks(self, axis) -> tuple[int, ...]:
        """Global ranks of this rank's line along ``axis``, in order."""
        names = axis if isinstance(axis, tuple) else (axis,)
        grid = np.array(self.ranks).reshape(
            [self.shape[a] for a in self.axis_names])
        index = tuple(slice(None) if name in names else c
                      for name, c in zip(self.axis_names, self.coords))
        sub = grid[index]
        # order the kept axes as ``names`` lists them
        kept = [name for name in self.axis_names if name in names]
        sub = np.transpose(sub, [kept.index(name) for name in names])
        return tuple(int(r) for r in sub.reshape(-1))


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("a mesh needs an initialized torch.distributed "
                           "process group (parallel.launch.spawn starts one)")
    return dist.get_world_size()


def _line_groups(grid: np.ndarray, axis: int) -> list[tuple[int, ...]]:
    """The rank lines of ``grid`` along ``axis``, in row-major order of
    the other axes."""
    moved = np.moveaxis(grid, axis, -1)
    return [tuple(int(r) for r in line)
            for line in moved.reshape(-1, grid.shape[axis])]


def _new_group(ranks: tuple[int, ...]):
    """The process group of ``ranks``: the world's own group when it
    spans the world.  Every rank of the world calls this for every group,
    in the same order, as ``new_group`` requires."""
    if len(ranks) == dist.get_world_size() and ranks == tuple(sorted(ranks)):
        return dist.group.WORLD
    return dist.new_group(list(ranks))


def _build(axis_names: tuple[str, ...], dims: tuple[int, ...]) -> Mesh:
    n = math.prod(dims)
    world = _world()
    if n > world:
        raise ValueError(f"the mesh needs {n} ranks, the world has {world}")
    grid = np.arange(n).reshape(dims)
    me = dist.get_rank()
    coords = (tuple(int(c) for c in np.argwhere(grid == me)[0])
              if me < n else None)
    groups = {}
    keys = [(name, i) for i, name in enumerate(axis_names)]
    for name, i in keys:
        for line in _line_groups(grid, i):
            g = _new_group(line)
            if me in line:
                groups[name] = g
    flat = tuple(axis_names)
    if len(axis_names) > 1:
        g = _new_group(tuple(range(n)))
        if me < n:
            groups[flat] = g
    elif me < n:
        groups[flat] = groups[axis_names[0]]
    return Mesh(axis_names, dict(zip(axis_names, dims)), tuple(range(n)),
                coords, groups)


def make_mesh(n_devices: int | None = None, axis: str = ROWS_AXIS) -> Mesh:
    """1-D mesh over the first ``n_devices`` ranks of the world (default:
    all).  Every rank of the world calls it; a rank past ``n_devices``
    gets a mesh it is not in (``coords`` None)."""
    n = _world() if n_devices is None else n_devices
    return _build((axis,), (n,))


def make_mesh2d(n_slices: int, chips_per_slice: int,
                slice_axis: str = SLICE_AXIS,
                chip_axis: str = CHIP_AXIS) -> Mesh:
    """2-D (slices, chips_per_slice) mesh for the hierarchical tree,
    slice-major: ranks ``s * chips_per_slice .. (s + 1) *
    chips_per_slice - 1`` form slice s."""
    return _build((slice_axis, chip_axis), (n_slices, chips_per_slice))


def row_axes(mesh: Mesh, axis=ROWS_AXIS):
    """Reduction axes of the row sharding: on a multi-axis mesh the rows
    shard over all axes (the flattened tuple), as in the JAX package."""
    if axis == ROWS_AXIS and len(mesh.axis_names) > 1:
        return tuple(mesh.axis_names)
    return axis


def shard_index(mesh: Mesh, axis=ROWS_AXIS) -> tuple[int, int]:
    """(index, count) of this rank's row block along ``axis``."""
    axis = row_axes(mesh, axis)
    return comm.linear_index(mesh, axis), comm.axes_size(mesh, axis)


def row_shard(a, mesh: Mesh, axis=ROWS_AXIS):
    """This rank's rows of a whole (m, ...) matrix ``a`` (numpy array or
    tensor): block ``index`` of ``count`` equal row blocks, the rows the
    JAX mesh's device ``index`` holds under ``row_sharding``."""
    idx, count = shard_index(mesh, axis)
    m = a.shape[0]
    if m % count:
        raise ValueError(f"m={m} must divide over {count} ranks")
    per = m // count
    return a[idx * per:(idx + 1) * per]


def vec_shard(b, mesh: Mesh, axis=ROWS_AXIS):
    """This rank's entries of an (m,) vector, split like the rows of the
    matrix it pairs with (``vec_sharding`` in the JAX package)."""
    return row_shard(b, mesh, axis)
