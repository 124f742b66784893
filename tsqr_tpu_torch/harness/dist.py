"""The distributed layer on the card: the ranks' side of ``chip_smoke.py``'s
``distributed`` phase, and the models' runs that its ``models`` phase
makes on the single card and the ranks make over a mesh.

Every rank of a group that ``parallel.launch.spawn`` starts on the card
runs :func:`driver_rank`: the seven drivers on its (2^20, 128) rows of a
global (2^22, 128) float32 uniform[-1, 1] matrix (``ooc.uniform_gen``
chunk ``rank``), BlockQR at a global (2^20, 512), the matrix-free QR at
m = 2^26, the sketch, the eleven models' ``mesh=`` routes at their
single-card widths, and the gradients of three drivers.  Each driver's
first call is measured (global residual and orthogonality from float64
sums over the ranks, R, the tier, the wire counter and the panel
kernel's launches); three more calls are timed between CUDA events, the
ranks lined up by a barrier before each.  :func:`model_runs` makes each
model's global input whole from a seeded generator (the same bits on
every rank and on the single card), runs the model with or without a
mesh, and sums what it measures over the ranks where there is one.  The
ranks return numbers and small tensors; ``chip_smoke.py`` holds them to
its gates and to the single-card results.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed as dist

from tsqr_tpu_torch import models
from tsqr_tpu_torch.core import ooc
from tsqr_tpu_torch.ops import gram_stream, panel_kernel
from tsqr_tpu_torch.parallel import comm, dryrun, dtsqr
from tsqr_tpu_torch.parallel import mesh as mesh_mod

DEVICE = "cuda"
MODE = "bf16x6_cor"
N = 128
WORLD = 4
M_RANK = 1 << 20             # rows a rank: the global (2^22, 128)
M_WIDE_RANK = 1 << 18        # dqr's rows a rank: the global (2^20, 512)
N_WIDE = 512
ZERO_COL = 33                # the tier-4 input's zeroed column
REGEN_M, REGEN_CHUNK, REGEN_SEED = 1 << 26, 1 << 21, 7
SKETCH_L = 256
M_GRAD, N_GRAD = 1 << 14, 64
GRAD_MODE = "fp32"           # the rule's check, clear of the Gram floor
M_MODEL = 1 << 20
M_LSTSQ, KAPPA_LSTSQ, RIDGE = 1 << 18, 1e2, 1e-2
REPS = 3

# the drivers: name -> (input, call); the input "a" (the rank's rows),
# "a0" (column ZERO_COL zeroed), "aw" (dqr's rows)
DRIVERS = {
    "dqr_auto tier1": ("a", lambda a, m, m2: dtsqr.dqr_auto(
        a, m, MODE, return_info=True)),
    "dqr_auto tier4": ("a0", lambda a, m, m2: dtsqr.dqr_auto(
        a, m, MODE, return_info=True)),
    "dtsqr allgather": ("a", lambda a, m, m2: dtsqr.dtsqr(a, m, MODE)),
    "dtsqr butterfly": ("a", lambda a, m, m2: dtsqr.dtsqr(
        a, m, MODE, tree="butterfly")),
    "dtsqr_hier 2x2": ("a", lambda a, m, m2: dtsqr.dtsqr_hier(a, m2, MODE)),
    "dcholqr cholqr2 fp32": ("a", lambda a, m, m2: dtsqr.dcholqr(
        a, m, "fp32", method="cholqr2")),
    "dcholqr cholqr3 fp32": ("a", lambda a, m, m2: dtsqr.dcholqr(
        a, m, "fp32", method="cholqr3")),
    "dcholqr cholqr2 bf16x6_cor": ("a", lambda a, m, m2: dtsqr.dcholqr(
        a, m, MODE, method="cholqr2")),
    "dcholqr cholqr3 bf16x6_cor": ("a", lambda a, m, m2: dtsqr.dcholqr(
        a, m, MODE, method="cholqr3")),
    "dqr reorth": ("aw", lambda a, m, m2: dtsqr.dqr(a, m, MODE,
                                                   reorth=True)),
}
TREE_DRIVERS = ("dqr_auto tier4", "dtsqr allgather", "dtsqr butterfly",
                "dtsqr_hier 2x2", "dqr reorth")


def driver_input(kind: str, seed: int, index: int) -> torch.Tensor:
    """Row block ``index`` (a rank's rows) of a driver's global input;
    ``torch.cat`` of the blocks is the single-card input."""
    if kind == "aw":
        return ooc.uniform_gen(seed + 1, M_WIDE_RANK, N_WIDE,
                               dtype=torch.float32, device=DEVICE)(index)
    a = ooc.uniform_gen(seed, M_RANK, N, dtype=torch.float32,
                        device=DEVICE)(index)
    if kind == "a0":
        a[:, ZERO_COL] = 0.0
    return a


def launches() -> dict:
    return {"stream_gram": gram_stream.LAUNCHES,
            "stream_gram_reduce": gram_stream.REDUCE_LAUNCHES,
            "stream_wide_dot": gram_stream.WIDE_LAUNCHES,
            "stream_wide_gram": gram_stream.WIDE_GRAM_LAUNCHES,
            "stream_wide_dot_fp32": gram_stream.WIDE_FP32_LAUNCHES,
            "stream_wide_gram_fp32": gram_stream.WIDE_GRAM_FP32_LAUNCHES,
            "panel_qr": panel_kernel.LAUNCHES}


def _zero_launches() -> None:
    gram_stream.LAUNCHES = gram_stream.REDUCE_LAUNCHES = 0
    gram_stream.WIDE_LAUNCHES = gram_stream.WIDE_GRAM_LAUNCHES = 0
    gram_stream.WIDE_FP32_LAUNCHES = gram_stream.WIDE_GRAM_FP32_LAUNCHES = 0
    panel_kernel.LAUNCHES = 0


class Count:
    """The kernel launches of first calls only: ``start`` sets the counts
    to 0 just before a call, ``add`` reads them just after and adds them
    to ``total``."""

    def __init__(self):
        self.total = {k: 0 for k in launches()}

    def start(self):
        _zero_launches()

    def add(self) -> dict:
        now = launches()
        for k in now:
            self.total[k] += now[k]
        return now


def _cuda_ms(fn, reps: int, barrier: bool) -> list[float]:
    """Milliseconds of ``reps`` calls between CUDA events, each after a
    barrier of the group when ``barrier``."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        if barrier:
            dist.barrier()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out


# ---- the models, with or without a mesh -------------------------------------

def _sum(x: torch.Tensor, mesh) -> torch.Tensor:
    return x if mesh is None else comm.psum(x, mesh, mesh_mod.row_axes(mesh))


def _rows(x: torch.Tensor, mesh) -> torch.Tensor:
    return x if mesh is None else mesh_mod.row_shard(x, mesh).contiguous()


def _orth(u: torch.Tensor, mesh) -> float:
    u64 = u.double()
    g = _sum(u64.T @ u64, mesh)
    eye = torch.eye(g.shape[0], dtype=torch.float64, device=g.device)
    return float(torch.linalg.norm(g - eye)) / math.sqrt(g.shape[0])


def _rel(x: torch.Tensor, ref: torch.Tensor, mesh) -> float:
    d = (x.double() - ref.double())
    sq = _sum(torch.stack([torch.sum(d * d),
                           torch.sum(ref.double() ** 2)]), mesh)
    return float(torch.sqrt(sq[0] / sq[1]))


def _gen(seed: int, i: int) -> torch.Generator:
    return torch.Generator(device=DEVICE).manual_seed(
        ooc._chunk_seed(seed, 1000 + i))


def _latms(m: int, n: int, s: torch.Tensor, g) -> torch.Tensor:
    """(m, n) U diag(s) V^T with U, V the Q factors of Gaussians."""
    u = torch.linalg.qr(torch.randn(m, n, device=DEVICE, generator=g)).Q
    v = torch.linalg.qr(torch.randn(n, n, device=DEVICE, generator=g)).Q
    return ((u.double() * s.to(DEVICE, torch.float64)) @ v.double().T
            ).float()


def _timed(fn):
    """(fn(), its milliseconds between CUDA events)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def model_runs(seed: int, mesh=None, count: Count | None = None,
               reps: int = 1) -> dict:
    """Each model of ``models/`` at the width its users run, on its
    global input (or, with ``mesh``, this rank's rows of it): {name:
    row}.  A row holds ``ms`` (the first call and ``reps - 1`` more
    between CUDA events), the first call's kernel launches where
    ``count`` is given, and the readings of the first call's result: its
    float64 errors against what the input plants (the spectrum, the
    float64 solution, the rank) and the results a mesh route is held to
    the single card by; the sums over rows are taken over the ranks, so
    that the single-card and the mesh runs read alike.  Without a mesh,
    the entries that have none run too: ``lstsq_cgls``, ``procrustes``
    and ``cca``'s other QR routes."""
    dev = torch.device(DEVICE)
    kw = {} if mesh is None else {"mesh": mesh}
    out = {}

    def run(name, fn, check):
        if count is not None:
            count.start()
        res, ms = _timed(fn)
        row = {} if count is None else {"launches": count.add()}
        row.update(check(res))
        del res
        row["ms"] = [ms] + _cuda_ms(fn, reps - 1, mesh is not None)
        out[name] = row

    def rand(g, *shape):
        return torch.rand(*shape, device=dev, generator=g) * 2 - 1

    def rel_max(x, ref) -> float:
        return float(((x.double() - ref.double()).abs() / ref.double())
                     .max())

    a = rand(_gen(seed, 0), M_MODEL, N)
    al = _rows(a, mesh)
    al64 = al.double()
    s64 = torch.linalg.eigvalsh(_sum(al64.T @ al64, mesh)).flip(0).sqrt()
    del al64

    def svd_check(r):
        u, s, vt = r
        return {"s": s.cpu(), "s_rel_err_vs_fp64": rel_max(s, s64),
                "u_orthogonality": _orth(u, mesh),
                "residual": _rel((u.double() * s.double()) @ vt.double(),
                                 al, mesh)}

    def polar_check(r):
        u, h = r
        h64 = h.double()
        return {"h": h.cpu(), "u_orthogonality": _orth(u, mesh),
                "residual": _rel(u.double() @ h64, al, mesh),
                "h_asymmetry": float((h - h.T).abs().max()),
                "h_min_eig_rel": float(torch.linalg.eigvalsh(h64)[0]
                                       / torch.linalg.matrix_norm(h64, 2))}

    run("tsqr_svd", lambda: models.tsqr_svd(al, MODE, "cholqr3_fused", **kw),
        svd_check)
    run("polar", lambda: models.polar(al, MODE, **kw), polar_check)
    if mesh is None:
        # a planted rotation
        g = _gen(seed, 13)
        om_true = torch.linalg.qr(torch.randn(N, N, device=dev,
                                              generator=g)).Q
        b = a @ om_true + 1e-4 * torch.randn(M_MODEL, N, device=dev,
                                             generator=g)
        run("procrustes", lambda: models.procrustes(a, b), lambda om: {
            "rotation_err": float(torch.linalg.norm(om - om_true))
            / math.sqrt(N), "orthogonality": _orth(om, None)})
        del b
    del a, al

    # exactly rank 120 at (2^20, 512)
    g = _gen(seed, 1)
    low = rand(g, M_MODEL, 120) @ rand(g, 120, N_WIDE)
    lowl = _rows(low, mesh)
    del low
    run("rsvd", lambda: models.rsvd(lowl, 120, _gen(seed, 2), **kw),
        lambda r: {"s": r[1].cpu(), "u_orthogonality": _orth(r[0], mesh),
                   "residual": _rel((r[0].double() * r[1].double())
                                    @ r[2].double(), lowl, mesh)})
    del lowl

    # a diagonal operator with a gapped spectrum: top eigenvalue 10
    d = torch.linspace(1.0, 0.0, M_MODEL, device=dev)
    d[:8] = torch.arange(10.0, 2.0, -1.0)
    dl = _rows(d, mesh)

    def lanczos_check(r):
        qb = r[0].double()
        t = _sum(qb.T @ (dl.double()[:, None] * qb), mesh)
        top = float(torch.linalg.eigvalsh(t)[-1])
        return {"top_ritz": top, "top_rel_err": abs(top - 10.0) / 10.0,
                "basis_orthogonality": _orth(r[0], mesh)}

    run("block_lanczos", lambda: models.block_lanczos(
        lambda x: dl[:, None] * x, M_MODEL, 128, 8, _gen(seed, 3), **kw),
        lanczos_check)

    # latms kappa = 1e2 at BlockQR's shape, plain and ridge, against the
    # float64 normal equations (kappa^2 eps64 ~ 1e-12)
    g = _gen(seed, 4)
    s = torch.logspace(0, -math.log10(KAPPA_LSTSQ), N_WIDE)
    am = _latms(M_LSTSQ, N_WIDE, s, g)
    b = am @ torch.randn(N_WIDE, device=dev, generator=g) + 1e-3 * torch.randn(
        M_LSTSQ, device=dev, generator=g)
    aml, bl = _rows(am, mesh), _rows(b, mesh)
    del am, b
    a64 = aml.double()
    gram64 = _sum(a64.T @ a64, mesh)
    atb64 = _sum(a64.T @ bl.double(), mesh)
    del a64
    eye = torch.eye(N_WIDE, dtype=torch.float64, device=dev)
    for ridge in (0.0, RIDGE):
        x64 = torch.linalg.solve(gram64 + ridge * eye, atb64)
        run(f"lstsq ridge={ridge}", lambda ridge=ridge: models.lstsq(
            aml, bl, MODE, ridge=ridge, **kw), lambda x, x64=x64: {
            "x": x.cpu(), "x_rel_err_vs_fp64": _rel(x, x64, None)})
    del aml, bl, gram64, atb64

    if mesh is None:
        # CGLS at kappa = 1e4 against the float64 least-squares residual
        g = _gen(seed, 14)
        s_c = (0.01 + 0.99 * torch.rand(N, dtype=torch.float64, device=dev,
                                        generator=g)).sort(
            descending=True).values
        s_c[0], s_c[-1] = 1.0, 1e-4
        ac = _latms(M_MODEL, N, s_c, g)
        bc = rand(g, M_MODEL)
        ac64, bc64 = ac.double(), bc.double()
        xc64 = torch.linalg.lstsq(ac64, bc64[:, None]).solution[:, 0]
        r_opt = float(torch.linalg.norm(ac64 @ xc64 - bc64))

        def cgls_check(r):
            x, info = r
            r_got = float(torch.linalg.norm(ac64 @ x.double() - bc64))
            return {"iters": info["iters"],
                    "grad_rel_max": float(info["grad_rel"].max()),
                    "residual_excess": r_got / r_opt - 1}

        run("lstsq_cgls", lambda: models.lstsq_cgls(
            lambda v: ac @ v, lambda v: ac.T @ v, bc, N, gen=g, tol=1e-6),
            cgls_check)
        del ac, bc, ac64, bc64

    # rank 64, every other column zero: the ladder runs through tier 4
    # (tier 3's shifted passes would fill the null directions with
    # amplified rounding; a zero column stays zero)
    a64r = rand(_gen(seed, 5), M_MODEL, N)
    a64r[:, 1::2] = 0.0
    a64l = _rows(a64r, mesh)
    del a64r

    def pqr_check(r):
        q, r_, piv, db = r
        return {"rank_from_diag_b": int((db > 1e-5 * db[0]).sum()),
                "residual": _rel(q.double() @ r_.double(), a64l[:, piv],
                                 mesh),
                "q_orthogonality": _orth(q, mesh)}

    run("pivoted_qr", lambda: models.pivoted_qr(a64l, _gen(seed, 6), MODE,
                                                **kw), pqr_check)
    del a64l

    # exact rank 32
    g = _gen(seed, 7)
    a32 = rand(g, M_MODEL, 32) @ rand(g, 32, N)
    a32l = _rows(a32, mesh)
    run("interpolative", lambda: models.interpolative(a32l, _gen(seed, 8), 32,
                                                      **kw),
        lambda r: {"reconstruction": _rel(a32l[:, r[0]] @ r[1], a32l, mesh)})
    run("cur", lambda: models.cur(a32l, _gen(seed, 9), 32, **kw),
        lambda r: {"reconstruction": _rel(a32l[:, r[0]] @ r[1] @ a32[r[2]],
                                          a32l, mesh)})
    del a32, a32l

    # diagonal operators: the top 32 of a gapped spectrum, and exact
    # rank 64 over a 10x range (the float32 whitening's error grows with
    # the order in both packages: lam's relative error on the CPU 8e-4
    # at 2^13, 2.5e-3 at 2^16)
    ds = torch.linspace(1.0, 0.0, M_MODEL, device=dev)
    ds[:36] = torch.linspace(10.0, 4.0, 36)
    dsl = _rows(ds, mesh)
    run("subspace_iteration", lambda: models.subspace_iteration(
        lambda x: dsl[:, None] * x, M_MODEL, 32, _gen(seed, 10), iters=20,
        return_resid=True, **kw), lambda r: {
        "w": r[0].cpu(), "eig_rel_err": rel_max(r[0], ds[:32]),
        "v_orthogonality": _orth(r[1], mesh),
        "max_resid": float(r[2].max())})
    dn = torch.zeros(M_MODEL, device=dev)
    dn[:64] = torch.linspace(1.0, 0.1, 64)
    dnl = _rows(dn, mesh)
    run("nystrom", lambda: models.nystrom(
        lambda x: dnl[:, None] * x, M_MODEL, 64, _gen(seed, 11), **kw),
        lambda r: {"lam": r[1].cpu(), "lam_rel_err": rel_max(r[1], dn[:64]),
                   "u_orthogonality": _orth(r[0], mesh)})

    # two planted shared directions
    g = _gen(seed, 12)
    z = torch.randn(M_MODEL, 2, device=dev, generator=g)
    x = torch.cat([z + 0.05 * torch.randn(M_MODEL, 2, device=dev, generator=g),
                   torch.randn(M_MODEL, N - 2, device=dev, generator=g)], 1)
    y = torch.cat([z + 0.05 * torch.randn(M_MODEL, 2, device=dev, generator=g),
                   torch.randn(M_MODEL, 62, device=dev, generator=g)], 1)
    xl, yl = _rows(x, mesh), _rows(y, mesh)
    del x, y, z

    def cca_check(r):
        c = r[0]
        return {"corrs": c.cpu(), "top2": c[:2].tolist(),
                "rest_max": float(c[2:].max())}

    run("cca", lambda: models.cca(xl, yl, mode=MODE, **kw), cca_check)
    if mesh is None:
        for method in ("auto", "cholqr2"):
            run(f"cca {method}", lambda method=method: models.cca(
                xl, yl, mode=MODE, method=method), cca_check)
    return out


def grad_inputs(seed: int) -> tuple[torch.Tensor, ...]:
    """(A, W1, W2) of the gradient cases, whole, on the card."""
    g = _gen(seed, 20)
    return tuple(torch.rand(*s, device=DEVICE, generator=g) * 2 - 1
                 for s in ((M_GRAD, N_GRAD), (M_GRAD, N_GRAD),
                           (N_GRAD, N_GRAD)))


def loss(q, r, w1, w2, with_r: bool = True) -> torch.Tensor:
    """vdot(Q S, W1) + vdot(S R, W2), S the signs of diag(R): the JAX
    package's gradient tests' loss; a rank adds the R term once."""
    s = torch.sign(torch.diagonal(r)).detach()
    s = torch.where(s == 0, 1.0, s)
    out = torch.sum(q * s[None, :] * w1)
    return out + torch.sum(r * s[:, None] * w2) if with_r else out


GRAD_DRIVERS = {"dtsqr": lambda a, m: dtsqr.dtsqr(a, m, GRAD_MODE),
                "dcholqr": lambda a, m: dtsqr.dcholqr(a, m, GRAD_MODE),
                "dqr_auto": lambda a, m: dtsqr.dqr_auto(a, m, GRAD_MODE)}


# ---- the ranks --------------------------------------------------------------

def driver_rank(rank: int, world: int, seed: int) -> dict:
    """One rank of the phase's 4-rank group on the card."""
    mesh = mesh_mod.make_mesh()
    mesh2 = mesh_mod.make_mesh2d(2, world // 2)
    count = Count()
    out = {"drivers": {}}
    inputs = {}
    for name, (kind, call) in DRIVERS.items():
        if kind not in inputs:
            inputs = {kind: driver_input(kind, seed, rank)}
        a = inputs[kind]
        m_ = mesh2 if "hier" in name else mesh
        dist.barrier()
        count.start()
        with comm.counting() as wire:
            res, ms = _timed(lambda: call(a, mesh, mesh2))
        row = {"launches": count.add(), "wire": wire.as_dict()}
        q, r = res[0], res[1]
        row["residual"], row["orthogonality"] = dryrun.metrics(a, q, r, m_)
        row["r"] = r.float().cpu()
        if len(res) == 3:
            row["tier"] = res[2]["tier"]
        del res, q
        row["ms"] = [ms] + _cuda_ms(lambda: call(a, mesh, mesh2), REPS - 1,
                                    True)
        out["drivers"][name] = row
    del inputs, a

    # the matrix-free QR: rank d makes chunks [d c, (d + 1) c) of the
    # global generator (the ooc phase's)
    gen = ooc.uniform_gen(REGEN_SEED, REGEN_CHUNK, N, dtype=torch.float32,
                          device=DEVICE)

    def regen():
        return dtsqr.dqr_regen(gen, REGEN_M, N, mesh, MODE, "cholqr2",
                               REGEN_CHUNK)

    dist.barrier()
    count.start()
    with comm.counting() as wire:
        (r, info), ms = _timed(regen)
    out["drivers"]["dqr_regen"] = {
        "launches": count.add(), "wire": wire.as_dict(), "r": r.cpu(),
        "orthogonality": float(info["orthogonality"]),
        "residual": float(info["residual"]),
        "ms": [ms] + _cuda_ms(regen, REPS - 1, True)}

    # the sketch: Omega A of the global (2^22, 128), l = 256
    a = driver_input("a", seed, rank)

    def sketch():
        return dtsqr.dsketch(a, seed, SKETCH_L, mesh)

    dist.barrier()
    count.start()
    with comm.counting() as wire:
        b, ms = _timed(sketch)
    out["drivers"]["dsketch"] = {
        "launches": count.add(), "wire": wire.as_dict(), "b": b.cpu(),
        "ms": [ms] + _cuda_ms(sketch, REPS - 1, True)}
    del a, b
    torch.cuda.empty_cache()

    out["models"] = model_runs(seed, mesh, count)
    torch.cuda.empty_cache()

    a, w1, w2 = grad_inputs(seed)
    al, w1l = mesh_mod.row_shard(a, mesh), mesh_mod.row_shard(w1, mesh)
    out["grads"] = {}
    for name, call in GRAD_DRIVERS.items():
        x = al.clone().requires_grad_()
        q, r = call(x, mesh)
        loss(q, r, w1l, w2, with_r=rank == 0).backward()
        out["grads"][name] = x.grad.cpu()
    out["launches"] = count.total
    return out


def nccl_rank(rank: int, world: int, seed: int) -> dict:
    """The one-rank NCCL group: dqr_auto and dtsqr on rank 0's rows."""
    mesh = mesh_mod.make_mesh()
    a = driver_input("a", seed, 0)
    out = {"backend": str(dist.get_backend())}
    for name, call in (("dqr_auto", lambda: dtsqr.dqr_auto(
            a, mesh, MODE, return_info=True)),
            ("dtsqr", lambda: dtsqr.dtsqr(a, mesh, MODE))):
        with comm.counting() as wire:
            res = call()
        out[name] = {"r": res[1].float().cpu(),
                     "metrics": dryrun.metrics(a, res[0], res[1], mesh),
                     "tier": res[2]["tier"] if len(res) == 3 else None,
                     "wire": wire.as_dict(),
                     "ms": float(np.median(_cuda_ms(call, REPS, False)))}
    return out
