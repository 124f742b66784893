"""The distributed port (tsqr_tpu_torch/parallel) against the JAX package's
(tsqr_tpu/parallel), on the CPU, on the same numpy inputs.

One 4-rank gloo group (``launch.spawn``) runs every case of the module
(``tests/_torch_parallel_ranks.py``) and hands back each rank's numpy
results; the tests hold them to JAX's drivers on ``make_mesh(4)`` /
``make_mesh2d(2, 2)`` of the 8-device CPU mesh that tests/conftest.py
forces.  The cases are tests/test_distributed.py's contracts: rank d's Q
rows and the replicated R against JAX's, relative 1e-5 in the Frobenius
norm (R only, beside the global orthogonality and residual, for the
ill-conditioned ladder inputs, whose Q two stable algorithms determine to
kappa eps), the same ladder tier, R the same bits on every rank for the
tree drivers, and the wire bytes from ``comm``'s counter where JAX scans
its compiled HLO.  The gradient rule is held to ``jax.grad`` and
``jax.jvp`` through JAX's drivers.  The skeletons' mesh routes
(test_distributed.py's last case) are held to JAX's in
tests/test_torch_hygiene.py, with every other model's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_threads  # noqa: F401
import _torch_parallel_ranks as ranks
from tsqr_tpu.core import cholqr as jcholqr
from tsqr_tpu.parallel import dtsqr as jd
from tsqr_tpu.parallel import mesh as jmesh
from tsqr_tpu_torch.core import blockqr, ooc
from tsqr_tpu_torch.parallel import launch
from tsqr_tpu_torch.utils import latms, validation


TOL = 1e-5
N_WIRE = 64


def _rand(m, n, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (m, n)).astype(
        np.float32)


def _rel(x, ref) -> float:
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _qr_case(fn, a, mesh="rows4", **kw):
    return {"fn": fn, "a": a, "mesh": mesh, "kw": kw}


def _omegas(key, l, m, world=4):
    """The JAX package's dsketch draw: rank d's (l, m / world) block from
    fold_in(key, d) (one chunk: m / world <= its chunk_rows)."""
    return [np.asarray(jax.random.normal(jax.random.fold_in(key, d),
                                         (l, m // world), jnp.float32))
            for d in range(world)]


def _inputs() -> dict:
    """Every case of the module: {name: spec} (see _torch_parallel_ranks)."""
    k1 = latms.rand_matrix_with_cond(1, 1024, 32, 1e4)[0]
    k2 = latms.rand_matrix_with_cond(2, 1024, 32, 3e7)[0]
    k3 = latms.rand_matrix_with_cond(3, 1024, 32, 1e3)[0]
    k4 = latms.rand_matrix_with_cond(4, 1024, 32, 1e6)[0]
    cases = {
        "dtsqr_fp32": _qr_case("dtsqr", _rand(1024, 32), mode="fp32",
                               leaf_rows=128),
        "dtsqr_r16": _qr_case("dtsqr", _rand(1024, 16, 1), mode="fp32",
                              leaf_rows=128),
        "dqr_wide": _qr_case("dqr", _rand(1024, 96, 2), mode="fp32",
                             panel_width=32, leaf_rows=128),
        "dqr_reorth": _qr_case("dqr", _rand(1024, 64, 3), mode="fp32",
                               panel_width=16, reorth=True, leaf_rows=128),
        "hier_2x2": _qr_case("dtsqr_hier", _rand(1024, 32, 8), "2x2",
                             mode="fp32", leaf_rows=32),
        "hier_4x1": _qr_case("dtsqr_hier", _rand(1024, 32, 8), "4x1",
                             mode="fp32", leaf_rows=32),
        "butterfly": _qr_case("dtsqr", _rand(1024, 32, 7), mode="fp32",
                              leaf_rows=128, tree="butterfly"),
        "butterfly_r16": _qr_case("dtsqr", _rand(1024, 16, 8), mode="fp32",
                                  leaf_rows=128, tree="butterfly"),
        "dqr_butterfly": _qr_case("dqr", _rand(1024, 64, 9), mode="fp32",
                                  panel_width=16, leaf_rows=128,
                                  tree="butterfly"),
        "dcholqr_cholqr2": _qr_case("dcholqr", _rand(1024, 32, 5),
                                    mode="fp32", method="cholqr2"),
        "dcholqr_cholqr3": _qr_case("dcholqr", _rand(1024, 32, 5),
                                    mode="fp32", method="cholqr3"),
        "dcholqr_corrected": _qr_case("dcholqr", _rand(2048, 64, 6),
                                      mode="bf16x6_cor", method="cholqr2"),
        "dtsqr_corrected": _qr_case("dtsqr", _rand(2048, 16, 4),
                                    mode="bf16x6_cor", leaf_rows=128),
        "auto_k1": _qr_case("dqr_auto", _rand(1024, 32, 3), mode="fp32",
                            leaf_rows=64, return_info=True),
        "auto_k1e4": _qr_case("dqr_auto", k1, mode="fp32", leaf_rows=64,
                              return_info=True),
        "auto_k3e7": _qr_case("dqr_auto", k2, mode="fp32", leaf_rows=64,
                              return_info=True),
        "auto_k1e3": _qr_case("dqr_auto", k3, mode="fp32", leaf_rows=64,
                              return_info=True),
        "auto_k1e6": _qr_case("dqr_auto", k4, mode="fp32", leaf_rows=64,
                              return_info=True),
        "auto_corrected": _qr_case("dqr_auto", _rand(1024, 32, 3),
                                   mode="bf16x6_cor", leaf_rows=64,
                                   return_info=True),
        "auto_fast": _qr_case("dqr_auto", _rand(2048, 32, 4), mode="fp32"),
        "regen_fp32": {"fn": "dqr_regen", "mesh": "rows4", "m": 4096,
                       "n": 32, "chunk": 256, "seed": 9, "dtype": "float32",
                       "kw": dict(mode="fp32", method="cholqr2")},
        "regen_bf16_cholqr3": {"fn": "dqr_regen", "mesh": "rows4",
                               "m": 4096, "n": 32, "chunk": 128, "seed": 10,
                               "dtype": "bfloat16",
                               "kw": dict(mode="bf16x6_cor",
                                          method="cholqr3")},
        "regen_iter": {"fn": "dqr_regen", "mesh": "rows4", "m": 4096,
                       "n": 32, "chunk": 256,
                       "a": latms.rand_matrix_with_cond(41, 4096, 32, 1e6)[0],
                       "kw": dict(mode="fp32", method="cholqr_iter")},
        "regen_2x2": {"fn": "dqr_regen", "mesh": "2x2", "m": 2048, "n": 32,
                      "chunk": 128, "seed": 3, "dtype": "float32",
                      "kw": dict(mode="fp32", method="cholqr2")},
        "dsketch": {"fn": "dsketch", "mesh": "rows4", "a": _rand(1024, 16,
                                                                  30),
                    "l": 40, "omegas": _omegas(jax.random.PRNGKey(7), 40,
                                               1024)},
        "rand_cholqr": {"fn": "rand_cholqr", "mesh": "rows4",
                        "a": latms.rand_matrix_with_cond(31, 4096, 48,
                                                         1e5)[0],
                        "omegas": _omegas(jax.random.PRNGKey(0), 96, 4096)},
    }
    for name, fn, kw in (
            ("dcholqr", "dcholqr", dict(mode="fp32")),
            ("dqr", "dqr", dict(mode="fp32", reorth=True, panel_width=16,
                                leaf_rows=32)),
            ("dqr_auto", "dqr_auto", dict(mode="fp32", leaf_rows=32)),
            ("dtsqr", "dtsqr", dict(mode="fp32", leaf_rows=32))):
        cases[f"2d_{name}"] = _qr_case(fn, _rand(1024, 32, 13), "2x2", **kw)
    for d, mesh in ((2, "rows2"), (4, "rows4")):
        for scale in (1, 4):
            cases[f"wire_ag_{d}_{scale}"] = _qr_case(
                "dtsqr", _rand(512 * scale * d, N_WIRE, d), mesh,
                mode="fp32")
        a = _rand(512 * d, N_WIRE, d)
        cases[f"wire_bf_{d}"] = _qr_case("dtsqr", a, mesh, mode="fp32",
                                         tree="butterfly")
        cases[f"wire_chol_{d}"] = _qr_case("dcholqr", a, mesh, mode="fp32",
                                           method="cholqr2")
    a, w1, w2 = _grad_inputs()
    for driver, kw in (("dtsqr", dict(mode="fp32", leaf_rows=32)),
                       ("dcholqr", dict(mode="fp32", method="cholqr2")),
                       ("dqr_auto", dict(mode="fp32", leaf_rows=32))):
        cases[f"grad_{driver}"] = {"fn": "grad", "driver": driver,
                                   "mesh": "rows4", "a": a, "w1": w1,
                                   "w2": w2, "kw": kw}
    rng = np.random.default_rng(12)
    cases["grad_lstsq"] = {
        "fn": "grad_lstsq", "mesh": "rows4", "a": _rand(512, 16, 12),
        "b": rng.uniform(-1, 1, 512).astype(np.float32),
        "w": rng.uniform(-1, 1, 16).astype(np.float32)}
    cases["jvp_dtsqr"] = {"fn": "jvp", "driver": "dtsqr", "mesh": "rows4",
                          "a": a, "t": w1, "kw": dict(mode="fp32",
                                                      leaf_rows=32)}
    return cases


def _grad_inputs():
    rng = np.random.default_rng(8)
    return [rng.uniform(-1, 1, s).astype(np.float32)
            for s in ((256, 16), (256, 16), (16, 16))]


@pytest.fixture(scope="module")
def cases():
    return _inputs()


@pytest.fixture(scope="module")
def res(cases):
    """{case: [rank 0's result, ..., rank 3's]} from one 4-rank group."""
    out = launch.spawn(4, ranks.driver_cases, (cases,), backend="gloo",
                       device="cpu", timeout=600)
    return {name: [out[d][name] for d in range(4)] for name in cases}


@pytest.fixture(scope="module")
def mesh4():
    assert len(jax.devices()) >= 8, "conftest must force 8 CPU devices"
    return jmesh.make_mesh(4)


@functools.lru_cache(maxsize=None)
def _jitted(fn, mesh, kw: tuple):
    return jax.jit(lambda x: fn(x, mesh, **dict(kw)))


def _jax_run(fn, a, mesh, **kw):
    """JAX's driver on the row-sharded ``a``, jitted once per driver,
    mesh and options (an eager shard_map runs op by op, several times
    slower)."""
    ax = jax.device_put(jnp.asarray(a), jmesh.row_sharding(mesh))
    return _jitted(fn, mesh, tuple(sorted(kw.items())))(ax)


def _gather(rs, key):
    return np.concatenate([r[key] for r in rs if r is not None])


def _same_r(rs) -> bool:
    rs = [r["r"] for r in rs if r is not None]
    return all(np.array_equal(r, rs[0]) for r in rs)


def _check_qr(rs, a, tol=1e-6):
    q, r = _gather(rs, "q"), rs[0]["r"]
    assert np.allclose(np.triu(r), r)
    assert validation.residual(a, q, r) < tol
    assert validation.orthogonality(q) < tol
    return q, r


def _match(rs, jout, tol=TOL, q_too=True):
    q, r = _gather(rs, "q"), rs[0]["r"]
    assert _rel(r, jout[1]) <= tol, _rel(r, jout[1])
    if q_too:
        assert _rel(q, jout[0]) <= tol, _rel(q, jout[0])


# ---- the tree drivers ------------------------------------------------------

def test_dtsqr_fp32(res, cases, mesh4):
    a = cases["dtsqr_fp32"]["a"]
    rs = res["dtsqr_fp32"]
    _check_qr(rs, a)
    assert _same_r(rs)
    _match(rs, _jax_run(jd.dtsqr, a, mesh4, mode="fp32", leaf_rows=128))


def test_dtsqr_matches_single_device_R(res, cases):
    from tsqr_tpu.core import tsqr as jtsqr

    a = cases["dtsqr_r16"]["a"]
    rd = res["dtsqr_r16"][0]["r"]
    rs = np.asarray(jtsqr.tsqr(jnp.asarray(a), "fp32", leaf_rows=128)[1])
    s = np.sign(np.diag(rd)) * np.sign(np.diag(rs))
    np.testing.assert_allclose(rd * s[:, None], rs, rtol=0, atol=1e-5)


def test_dqr_blocked_wide(res, cases, mesh4):
    a = cases["dqr_wide"]["a"]
    rs = res["dqr_wide"]
    q, r = _gather(rs, "q"), rs[0]["r"]
    assert validation.residual(a, q, r) < 1e-6
    assert validation.orthogonality(q) < 1e-5
    assert _same_r(rs)
    _match(rs, _jax_run(jd.dqr, a, mesh4, mode="fp32", panel_width=32,
                        leaf_rows=128))


def test_dqr_reorth(res, cases, mesh4):
    a = cases["dqr_reorth"]["a"]
    rs = res["dqr_reorth"]
    q, r = _gather(rs, "q"), rs[0]["r"]
    assert validation.orthogonality(q) < 5e-6
    assert validation.residual(a, q, r) < 1e-5
    _match(rs, _jax_run(jd.dqr, a, mesh4, mode="fp32", panel_width=16,
                        reorth=True, leaf_rows=128))


@pytest.mark.parametrize("shape", ["2x2", "4x1"])
def test_dtsqr_hier_two_level(res, cases, shape):
    name = f"hier_{shape}"
    a = cases[name]["a"]
    rs = res[name]
    q, r = _check_qr(rs, a)
    assert _same_r(rs)
    r_ref = np.linalg.qr(a.astype(np.float64))[1]
    assert np.allclose(np.abs(r), np.abs(r_ref), rtol=1e-4, atol=1e-5)
    m2 = jmesh.make_mesh2d(*map(int, shape.split("x")))
    _match(rs, _jax_run(jd.dtsqr_hier, a, m2, mode="fp32", leaf_rows=32))


def test_gram_psum_drivers_on_2d_mesh(res, cases):
    m2 = jmesh.make_mesh2d(2, 2)
    jfn = {"dcholqr": jd.dcholqr, "dqr": jd.dqr, "dqr_auto": jd.dqr_auto,
           "dtsqr": jd.dtsqr}
    for name, fn in jfn.items():
        case = cases[f"2d_{name}"]
        rs = res[f"2d_{name}"]
        _check_qr(rs, case["a"])
        _match(rs, _jax_run(fn, case["a"], m2, **case["kw"]))
    reg = res["regen_2x2"][0]
    assert reg["orth"] < 1e-5 and reg["resid"] < 1e-5
    assert all(np.array_equal(r["r"], reg["r"]) for r in res["regen_2x2"])


def test_dtsqr_butterfly(res, cases, mesh4):
    a = cases["butterfly"]["a"]
    rs = res["butterfly"]
    _check_qr(rs, a)
    assert _same_r(rs)
    _match(rs, _jax_run(jd.dtsqr, a, mesh4, mode="fp32", leaf_rows=128,
                        tree="butterfly"))


def test_dtsqr_butterfly_matches_allgather_R(res, cases, mesh4):
    a = cases["butterfly_r16"]["a"]
    rb = res["butterfly_r16"][0]["r"]
    _, rg = _jax_run(jd.dtsqr, a, mesh4, mode="fp32", leaf_rows=128)
    rg = np.asarray(rg)
    s = np.sign(np.diag(rb)) * np.sign(np.diag(rg))
    np.testing.assert_allclose(rb * s[:, None], rg, rtol=0, atol=1e-5)


def test_dqr_butterfly_tree(res, cases, mesh4):
    a = cases["dqr_butterfly"]["a"]
    rs = res["dqr_butterfly"]
    q, r = _gather(rs, "q"), rs[0]["r"]
    assert validation.residual(a, q, r) < 1e-6
    assert validation.orthogonality(q) < 1e-5
    _match(rs, _jax_run(jd.dqr, a, mesh4, mode="fp32", panel_width=16,
                        leaf_rows=128, tree="butterfly"))


# ---- the Gram drivers -------------------------------------------------------

@pytest.mark.parametrize("method", ["cholqr2", "cholqr3"])
def test_dcholqr(res, cases, mesh4, method):
    name = f"dcholqr_{method}"
    a = cases[name]["a"]
    rs = res[name]
    _check_qr(rs, a)
    _match(rs, _jax_run(jd.dcholqr, a, mesh4, mode="fp32", method=method))


def test_dcholqr_corrected(res, cases, mesh4):
    a = cases["dcholqr_corrected"]["a"]
    rs = res["dcholqr_corrected"]
    _check_qr(rs, a, tol=1e-5)
    _match(rs, _jax_run(jd.dcholqr, a, mesh4, mode="bf16x6_cor",
                        method="cholqr2"))


def test_dtsqr_corrected_mode(res, cases, mesh4):
    a = cases["dtsqr_corrected"]["a"]
    rs = res["dtsqr_corrected"]
    _check_qr(rs, a, tol=1e-5)
    _match(rs, _jax_run(jd.dtsqr, a, mesh4, mode="bf16x6_cor",
                        leaf_rows=128))


# Ladder inputs whose tier-2 step factors a Gram G2 = Q1^T Q1 with
# kappa(G2) at or past 1/eps32 = 8.4e6, where whether float32 G2 is
# numerically positive definite is a matter of rounding.  Readings of the
# tier-2 steps on the four shards (Gram sums in shard order, the same
# input Gram in both packages): auto_k3e7's G2 has kappa 1.1e8 in the
# port and 3.4e7 in JAX, auto_k1e6's 1.4e7 in the port and an eigenvalue
# of -3.7e-8 in JAX.  LAPACK factors the port's G2 and its tier 2 passes
# the measured gate at 1.4e-7 and 1.3e-7 (tol 1e-5); JAX's Cholesky
# returns NaN and its ladder goes on to tier 3.  Every other input takes
# JAX's tier.
_CHOLESKY_EDGE = {"auto_k3e7", "auto_k1e6"}


def _ladder(res, cases, mesh4, name, orth_tol=1e-5, resid_tol=1e-4,
            q_too=False):
    """A ladder case: global metrics, JAX's tier and R (and Q where the
    input is well conditioned)."""
    case = cases[name]
    rs = res[name]
    q, r = _gather(rs, "q"), rs[0]["r"]
    assert np.allclose(np.triu(r), r)
    assert validation.orthogonality(q) < orth_tol
    assert validation.residual(case["a"], q, r) < resid_tol
    jq, jr, info = _jax_run(jd.dqr_auto, case["a"], mesh4, **case["kw"])
    tier, jtier = rs[0]["tier"], int(info["tier"][0, 0])
    if name in _CHOLESKY_EDGE:
        assert (tier, jtier) == (2, 3), (tier, jtier)
    else:
        assert tier == jtier, (tier, jtier)
    assert all(x["tier"] == tier for x in rs)
    _match(rs, (jq, jr), q_too=q_too)
    return tier


@pytest.mark.parametrize("kappa", ["k1", "k1e4", "k3e7"])
def test_dqr_auto_predictive_ladder(res, cases, mesh4, kappa):
    _ladder(res, cases, mesh4, f"auto_{kappa}", q_too=kappa == "k1")


def test_dqr_auto_return_info_tier(res, cases, mesh4):
    assert _ladder(res, cases, mesh4, "auto_k1", orth_tol=1e-6,
                   q_too=True) == 1
    assert _ladder(res, cases, mesh4, "auto_k1e3") == 2
    assert _ladder(res, cases, mesh4, "auto_k1e6") in (2, 3)
    assert _ladder(res, cases, mesh4, "auto_corrected", q_too=True) == 1


def test_dqr_auto_fast_tier_matches_dcholqr1_math(res, cases, mesh4):
    a = cases["auto_fast"]["a"]
    rs = res["auto_fast"]
    q, r = _gather(rs, "q"), rs[0]["r"]
    assert validation.orthogonality(q) < 1e-6
    g = a.astype(np.float64).T @ a.astype(np.float64)
    assert np.linalg.norm(r.T @ r - g) / np.linalg.norm(g) < 1e-5
    _match(rs, _jax_run(jd.dqr_auto, a, mesh4, mode="fp32"))
    # the tier-1 run: one (n, n) Gram sum and no other payload
    assert rs[0]["wire"]["psum"] == (1, 32 * 32 * 4)
    assert "all_gather" not in rs[0]["wire"]


# ---- matrix-free and sketch -------------------------------------------------

def test_dqr_regen_matches_local(res, cases):
    case = cases["regen_fp32"]
    rd = res["regen_fp32"]
    assert rd[0]["orth"] < 1e-6 and rd[0]["resid"] < 1e-6
    assert all(np.array_equal(x["r"], rd[0]["r"]) for x in rd)
    gen = ooc.uniform_gen(case["seed"], case["chunk"], case["n"],
                          dtype=torch.float32, device="cpu")
    r_l, info_l = ooc.qr_regen(gen, case["m"], case["n"], "fp32",
                               method="cholqr2", chunk_rows=case["chunk"],
                               device="cpu")
    r_l = r_l.double().numpy()
    assert np.allclose(rd[0]["r"], r_l, rtol=1e-4,
                       atol=1e-5 * np.abs(r_l).max())
    g0 = gen(0).double().numpy()
    q0_d, q0_l = g0 @ rd[0]["rinv"], g0 @ info_l["rinv"].double().numpy()
    assert np.allclose(q0_d, q0_l, rtol=1e-4, atol=1e-6)


def test_dqr_regen_bf16_cholqr3(res):
    rd = res["regen_bf16_cholqr3"][0]
    assert rd["orth"] < 1e-5 and rd["resid"] < 1e-5


def test_dqr_regen_cholqr_iter_deep_kappa(res, cases):
    rd = res["regen_iter"]
    assert rd[0]["orth"] < 1e-5 and rd[0]["resid"] < 1e-4
    assert all(np.array_equal(x["r"], rd[0]["r"]) for x in rd)
    # the same loop in one process: the same R to the sums' order
    case = cases["regen_iter"]
    a = torch.from_numpy(case["a"])
    chunk = case["chunk"]
    r_l, _ = ooc.qr_regen(lambda i: a[i * chunk:(i + 1) * chunk],
                          case["m"], case["n"], "fp32", method="cholqr_iter",
                          chunk_rows=chunk, device="cpu")
    assert _rel(rd[0]["r"], r_l.double().numpy()) <= TOL


def test_dsketch_matches_manual_shard_sum(res, cases, mesh4):
    case = cases["dsketch"]
    b = res["dsketch"][0]["b"]
    assert all(np.array_equal(x["b"], b) for x in res["dsketch"])
    jb = np.asarray(_jax_run(
        lambda x, m: jd.dsketch(x, jax.random.PRNGKey(7), case["l"], m),
        case["a"], mesh4))
    np.testing.assert_allclose(b, jb, rtol=0, atol=1e-4)
    per = 1024 // 4
    expect = sum(np.asarray(jcholqr.sketch_gaussian(
        jnp.asarray(case["a"][d * per:(d + 1) * per]),
        jax.random.fold_in(jax.random.PRNGKey(7), d), case["l"]))
        for d in range(4))
    np.testing.assert_allclose(b, expect, rtol=0, atol=1e-4)
    assert res["dsketch"][0]["wire"]["psum"] == (1, case["l"] * 16 * 4)


def test_rand_cholqr_mesh(res, cases, mesh4):
    case = cases["rand_cholqr"]
    rs = res["rand_cholqr"]
    q, r = _gather(rs, "q"), rs[0]["r"]
    assert validation.orthogonality(q) < 1e-5
    assert validation.residual(case["a"], q, r) < 1e-1
    jq, jr = _jax_run(lambda x, m: jcholqr.rand_cholqr(x, "fp32", mesh=m),
                      case["a"], mesh4)
    assert _rel(r, jr) <= TOL


# ---- bytes on the wire (JAX: its compiled HLO; here: comm's counter) --------

@pytest.mark.parametrize("d", [2, 4])
def test_wire_bytes_allgather_tree_scales_with_D(res, d):
    w = res[f"wire_ag_{d}_1"][0]["wire"]
    assert w["all_gather"] == (1, d * N_WIRE * N_WIRE * 4)
    assert "psum" not in w and "exchange" not in w
    # m-independence: 4x taller input, identical wire bytes
    assert res[f"wire_ag_{d}_4"][0]["wire"]["all_gather"] == w["all_gather"]
    assert all(x is None for x in res[f"wire_ag_{d}_1"][d:])


def test_wire_bytes_butterfly_tree_scales_with_log2_D(res):
    for d in (2, 4):
        w = res[f"wire_bf_{d}"][0]["wire"]
        levels = d.bit_length() - 1
        assert w["exchange"] == (levels, levels * N_WIRE * N_WIRE * 4)
        assert "all_gather" not in w


def test_wire_bytes_dcholqr2_independent_of_D(res):
    seen = [res[f"wire_chol_{d}"][0]["wire"]["psum"] for d in (2, 4)]
    assert seen[0] == seen[1] == (2, 2 * N_WIRE * N_WIRE * 4)


# ---- the gradient rule ------------------------------------------------------

def _jax_loss(fn, w1, w2):
    def loss(x):
        q, r = fn(x)
        s = jnp.sign(jnp.diagonal(r))
        s = jnp.where(s == 0, 1.0, s)
        return (jnp.vdot(q.astype(jnp.float32) * s[None, :], w1)
                + jnp.vdot(r.astype(jnp.float32) * s[:, None], w2))
    return loss


@pytest.mark.parametrize("driver", ["dtsqr", "dcholqr", "dqr_auto"])
def test_grad_distributed_drivers(res, cases, mesh4, driver):
    case = cases[f"grad_{driver}"]
    ax = jax.device_put(jnp.asarray(case["a"]), jmesh.row_sharding(mesh4))
    fn = getattr(jd, driver)
    g_ref = np.asarray(jax.jit(jax.grad(_jax_loss(
        lambda x: fn(x, mesh4, **case["kw"]), jnp.asarray(case["w1"]),
        jnp.asarray(case["w2"]))))(ax))
    per = g_ref.shape[0] // 4
    for d, x in enumerate(res[f"grad_{driver}"]):
        assert _rel(x["g"], g_ref[d * per:(d + 1) * per]) <= TOL, d


def test_grad_through_lstsq_mesh_route(res, cases, mesh4):
    # the model's own sum over the ranks (Q^T b) carries the gradient
    import tsqr_tpu.models as jm

    case = cases["grad_lstsq"]
    ax = jax.device_put(jnp.asarray(case["a"]), jmesh.row_sharding(mesh4))
    bx = jax.device_put(jnp.asarray(case["b"]), jmesh.vec_sharding(mesh4))
    w = jnp.asarray(case["w"])
    ga, gb = jax.jit(jax.grad(lambda a, b: jnp.vdot(jm.lstsq(
        a, b, "fp32", mesh=mesh4, leaf_rows=32), w), argnums=(0, 1)))(ax, bx)
    rs = res["grad_lstsq"]
    assert _rel(_gather(rs, "ga"), ga) <= TOL
    assert _rel(_gather(rs, "gb"), gb) <= TOL


def test_jvp_distributed_dtsqr(res, cases, mesh4):
    case = cases["jvp_dtsqr"]
    ax = jax.device_put(jnp.asarray(case["a"]), jmesh.row_sharding(mesh4))
    tx = jax.device_put(jnp.asarray(case["t"]), jmesh.row_sharding(mesh4))
    (_, r), (dq, dr) = jax.jit(lambda x, t: jax.jvp(
        lambda y: jd.dtsqr(y, mesh4, **case["kw"]), (x,), (t,)))(ax, tx)
    # in the signs that make diag(R) positive: the trees may differ
    s = jnp.sign(jnp.diagonal(r))
    s = jnp.where(s == 0, 1.0, s)
    dq, dr = dq * s[None, :], dr * s[:, None]
    rs = res["jvp_dtsqr"]
    assert _rel(_gather(rs, "dq"), dq) <= TOL
    assert all(_rel(x["dr"], dr) <= TOL for x in rs)


# ---- the single-process path is untouched ----------------------------------

def test_launchers_default_to_the_card(monkeypatch):
    """spawn, dryrun.run and the dry run's command line run on the card
    unless asked for the CPU: with no card the command line says so and
    starts no rank."""
    import inspect

    from tsqr_tpu_torch.parallel import dryrun

    for fn in (launch.spawn, dryrun.run):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(launch, "spawn",
                        lambda *a, **k: pytest.fail("a rank started"))
    assert dryrun.main(["4"]) == 2


def test_panel_step_identity_reduce_keeps_single_card_bits():
    a = torch.from_numpy(_rand(512, 48, 11))
    outs = []
    for kw in ({}, {"reduce": lambda x: x}):
        q = torch.zeros(512, 48)
        r = torch.zeros(48, 48)

        def tsqr_fn(x):
            return torch.linalg.qr(x)

        for c0 in range(0, 48, 16):
            blockqr._panel_step(q, r, a[:, c0:c0 + 16], c0,
                                torch.matmul, tsqr_fn, True, **kw)
        outs.append((q, r))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    q, r = blockqr.qr(a, "fp32", panel_width=16, reorth=True, device="cpu")
    assert validation.orthogonality(q) < 1e-6
