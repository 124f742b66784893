"""The ranks' side of the distributed port's tests.

``tests/test_torch_parallel.py`` and ``tests/test_torch_hygiene.py``
hand these functions to ``tsqr_tpu_torch.parallel.launch.spawn``: each
runs in a process of a 4-rank gloo group on the CPU, so this module
imports torch and the port and never JAX.  The tests make every input
with numpy (and the JAX package's random draws, where a case replaces
the port's), and get numpy results back, one dict a rank.
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch
import torch.autograd.forward_ad as fwad

from tsqr_tpu_torch import models, modes
from tsqr_tpu_torch.core import cholqr, ooc
from tsqr_tpu_torch.parallel import comm, dtsqr
from tsqr_tpu_torch.parallel import mesh as mesh_mod

CPU = "cpu"
# the modules, which the package's re-exported functions shadow
lanczos, qrcp, rsvd, subspace = (
    importlib.import_module(f"tsqr_tpu_torch.models.{name}")
    for name in ("lanczos", "qrcp", "rsvd", "subspace"))


def _np(x):
    return x.detach().cpu().to(torch.float64).numpy()


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32))


def _meshes() -> dict:
    """Every mesh of the cases, made in the same order on every rank:
    ``new_group`` is a collective of the whole world."""
    return {"rows4": mesh_mod.make_mesh(4), "rows2": mesh_mod.make_mesh(2),
            "2x2": mesh_mod.make_mesh2d(2, 2),
            "4x1": mesh_mod.make_mesh2d(4, 1)}


def _shard(x, mesh) -> torch.Tensor:
    return _t(mesh_mod.row_shard(x, mesh))


@contextlib.contextmanager
def _sketch_draws(omegas):
    """``dtsqr.dsketch``'s per-rank draw replaced by the test's: rank d's
    partial is omegas[d] @ A_d, the JAX package's ``dsketch`` partial
    for the same key."""
    keep = dtsqr._sketch_local
    dtsqr._sketch_local = (lambda a, seed, index, l, chunk_rows:
                           modes.mm_fp32(_t(omegas[index]), a))
    try:
        yield
    finally:
        dtsqr._sketch_local = keep


# ---- the drivers ----------------------------------------------------------

def _qr(case, mesh) -> dict:
    out = getattr(dtsqr, case["fn"])(_shard(case["a"], mesh), mesh,
                                     device=CPU, **case["kw"])
    res = {"q": _np(out[0]), "r": _np(out[1])}
    if len(out) == 3:
        res["tier"] = out[2]["tier"]
    return res


def _regen(case, mesh) -> dict:
    chunk, n = case["chunk"], case["n"]
    if "a" in case:
        a = _t(case["a"])

        def gen(i):
            return a[i * chunk:(i + 1) * chunk]
    else:
        gen = ooc.uniform_gen(case["seed"], chunk, n,
                              dtype=getattr(torch, case["dtype"]),
                              device=CPU)
    r, info = dtsqr.dqr_regen(gen, case["m"], n, mesh, chunk_rows=chunk,
                              device=CPU, **case["kw"])
    return {"r": _np(r), "orth": float(info["orthogonality"]),
            "resid": float(info["residual"]), "rinv": _np(info["rinv"])}


def _dsketch(case, mesh) -> dict:
    with _sketch_draws(case["omegas"]):
        b = dtsqr.dsketch(_shard(case["a"], mesh), 0, case["l"], mesh,
                          device=CPU)
    return {"b": _np(b)}


def _rand_cholqr(case, mesh) -> dict:
    with _sketch_draws(case["omegas"]):
        q, r = cholqr.rand_cholqr(_shard(case["a"], mesh), "fp32",
                                  mesh=mesh)
    return {"q": _np(q), "r": _np(r)}


def _grad(case, mesh) -> dict:
    """The gradient of the JAX tests' loss vdot(Qs, W1) + vdot(Rs, W2)
    (diag(R) made positive) through a driver: each rank adds its rows'
    term, and the first rank the R term."""
    a = _shard(case["a"], mesh).requires_grad_()
    q, r = getattr(dtsqr, case["driver"])(a, mesh, device=CPU, **case["kw"])
    s = torch.sign(torch.diagonal(r)).detach()
    s = torch.where(s == 0, 1.0, s)
    loss = torch.sum(q * s[None, :] * _shard(case["w1"], mesh))
    if comm.linear_index(mesh, mesh_mod.row_axes(mesh)) == 0:
        loss = loss + torch.sum(r * s[:, None] * _t(case["w2"]))
    loss.backward()
    return {"g": _np(a.grad)}


def _jvp(case, mesh) -> dict:
    a, t = _shard(case["a"], mesh), _shard(case["t"], mesh)
    with fwad.dual_level():
        q, r = getattr(dtsqr, case["driver"])(fwad.make_dual(a, t), mesh,
                                              device=CPU, **case["kw"])
        dq, dr = fwad.unpack_dual(q).tangent, fwad.unpack_dual(r).tangent
    return {"dq": _np(dq), "dr": _np(dr)}


def _grad_lstsq(case, mesh) -> dict:
    """d vdot(x, w) / d(A, b) through lstsq's mesh route: x is the same
    on every rank, so the first rank adds the loss."""
    a = _shard(case["a"], mesh).requires_grad_()
    b = _t(mesh_mod.vec_shard(case["b"], mesh)).requires_grad_()
    x = models.lstsq(a, b, "fp32", mesh=mesh, device=CPU, leaf_rows=32)
    loss = torch.sum(x * _t(case["w"]))
    if comm.linear_index(mesh, mesh_mod.row_axes(mesh)) != 0:
        loss = loss * 0.0
    loss.backward()
    return {"ga": _np(a.grad), "gb": _np(b.grad)}


_RUNNERS = {"dtsqr": _qr, "dtsqr_hier": _qr, "dqr": _qr, "dcholqr": _qr,
            "dqr_auto": _qr, "dqr_regen": _regen, "dsketch": _dsketch,
            "rand_cholqr": _rand_cholqr, "grad": _grad, "jvp": _jvp,
            "grad_lstsq": _grad_lstsq}


def driver_cases(rank: int, world: int, cases: dict) -> dict:
    """Every case of ``cases`` ({name: spec}) on this rank: its results
    and the collectives it ran (``comm.counting``); None where the rank
    is outside the case's mesh."""
    torch.set_num_threads(1)
    meshes = _meshes()
    out = {}
    for name, case in cases.items():
        mesh = meshes[case["mesh"]]
        if mesh.coords is None:
            out[name] = None
            continue
        with comm.counting() as wire:
            res = _RUNNERS[case["fn"]](case, mesh)
        res["wire"] = {op: tuple(v) for op, v in wire.ops.items()}
        out[name] = res
    return out


# ---- the models' mesh routes ------------------------------------------------

@contextlib.contextmanager
def _normal_draws(module, draws):
    """A model module's ``_normal`` replaced by the test's draws, in
    order (the JAX package's for the same key)."""
    keep = module._normal
    it = iter(draws)
    module._normal = lambda gen, shape, device: _t(next(it))
    try:
        yield
    finally:
        module._normal = keep


def _operator(amat, mesh):
    """matvec over a row-sharded symmetric operator: this rank's rows of
    A X from this rank's rows of X."""
    rows = _shard(amat, mesh)
    axis = mesh_mod.row_axes(mesh)
    return lambda x: modes.mm_fp32(rows, comm.all_gather_rows(x, mesh, axis))


def _model(name, case, mesh) -> dict:
    gen = torch.Generator().manual_seed(0)
    kw = dict(mesh=mesh, device=CPU)
    if name == "tsqr_svd":
        u, s, vt = models.tsqr_svd(_shard(case["a"], mesh), "fp32", **kw)
        return {"u": _np(u), "s": _np(s), "vt": _np(vt)}
    if name == "rsvd":
        with _normal_draws(rsvd, case["draws"]):
            u, s, vt = models.rsvd(_shard(case["a"], mesh), 10, gen,
                                   leaf_rows=64, **kw)
        return {"u": _np(u), "s": _np(s), "vt": _np(vt)}
    if name == "block_lanczos":
        with _normal_draws(lanczos, case["draws"]):
            qb, al, be = models.block_lanczos(
                _operator(case["amat"], mesh), case["amat"].shape[0], 8, 8,
                gen, leaf_rows=64, **kw)
        return {"q": _np(qb), "alphas": _np(al), "betas": _np(be)}
    if name == "lstsq":
        b = _t(mesh_mod.vec_shard(case["b"], mesh))
        x = models.lstsq(_shard(case["a"], mesh), b, "fp32", leaf_rows=64,
                         **kw)
        return {"x": _np(x)}
    if name in ("pivoted_qr", "interpolative", "cur"):
        row_sketch = case.get("omega_row")
        keep = qrcp._sketch
        if row_sketch is not None:
            qrcp._sketch = lambda at, g, l: modes.mm_fp32(_t(row_sketch), at)
        try:
            with _sketch_draws(case["omegas"]):
                a = _shard(case["a"], mesh)
                if name == "pivoted_qr":
                    q, r, piv, db = models.pivoted_qr(a, gen, leaf_rows=32,
                                                      **kw)
                    return {"q": _np(q), "r": _np(r), "piv": piv.numpy(),
                            "diag_b": _np(db)}
                if name == "interpolative":
                    cols, coeff, db = models.interpolative(a, gen, case["k"],
                                                           **kw)
                    return {"cols": cols.numpy(), "coeff": _np(coeff),
                            "diag_b": _np(db)}
                cols, u, rws = models.cur(a, gen, case["k"], **kw)
                return {"cols": cols.numpy(), "u": _np(u),
                        "rows": rws.numpy()}
        finally:
            qrcp._sketch = keep
    if name == "polar":
        u, h = models.polar(_shard(case["a"], mesh), **kw)
        return {"u": _np(u), "h": _np(h)}
    if name == "subspace_iteration":
        with _normal_draws(subspace, case["draws"]):
            w, v = models.subspace_iteration(
                _operator(case["amat"], mesh), case["amat"].shape[0], 4, gen,
                iters=10, **kw)
        return {"w": _np(w), "v": _np(v)}
    if name == "nystrom":
        with _normal_draws(subspace, case["draws"]):
            u, lam = models.nystrom(_operator(case["amat"], mesh),
                                    case["amat"].shape[0], 4, gen, **kw)
        return {"u": _np(u), "lam": _np(lam)}
    if name == "cca":
        c, wx, wy = models.cca(_shard(case["x"], mesh),
                               _shard(case["y"], mesh), **kw)
        return {"corrs": _np(c), "wx": _np(wx), "wy": _np(wy)}
    raise ValueError(f"no model case {name!r}")


def model_cases(rank: int, world: int, cases: dict) -> dict:
    """Each model's mesh route on a 4-rank 1-D mesh, for ``cases``
    ({model name: inputs})."""
    torch.set_num_threads(1)
    mesh = mesh_mod.make_mesh(4)
    return {name: _model(name, case, mesh) for name, case in cases.items()}


# ---- on the card ------------------------------------------------------------

def card_cases(rank: int, world: int, a) -> dict:
    """The tree and Gram drivers on the card, each rank's rows of ``a``:
    R, the global metrics (``dryrun.metrics``), the panel kernel's
    launches of the tree drivers and the collectives."""
    from tsqr_tpu_torch.parallel import dryrun
    from tsqr_tpu_torch.utils import trace

    mesh = mesh_mod.make_mesh()
    al = _shard(a, mesh).cuda()
    runs = {"allgather": lambda: dtsqr.dtsqr(al, mesh, "fp32"),
            "butterfly": lambda: dtsqr.dtsqr(al, mesh, "fp32",
                                             tree="butterfly"),
            "dcholqr": lambda: dtsqr.dcholqr(al, mesh, "fp32"),
            "dqr_auto": lambda: dtsqr.dqr_auto(al, mesh, "bf16x6_cor")}
    out = {}
    for name, fn in runs.items():
        launches = trace.counts("launches.")["panel_qr"]
        with comm.counting() as wire:
            q, r = fn()
        out[name] = {"r": _np(r), "metrics": dryrun.metrics(al, q, r, mesh),
                     "panel_launches":
                         trace.counts("launches.")["panel_qr"] - launches,
                     "wire": wire.as_dict()}
    return out
