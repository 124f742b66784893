"""The entry points' gradient rule (tsqr_tpu_torch/core/diff.py) against
the JAX package's (tsqr_tpu/core/diff.py), on the CPU, on the same numpy
inputs: reverse mode, forward mode, a second order, gradcheck of the
adjoint in float64, the paths the rule leaves unwrapped, and the device
move outside the rule."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tsqr_tpu
import tsqr_tpu_torch
from tsqr_tpu_torch.core import diff

torch.set_num_threads(2)

# same function, two packages: float32 rounding, amplified by kappa(A)
# (~5 for these uniform inputs) through R^{-1}
TOL = 1e-5

ENTRIES = {
    "fastqr_cholqr2": ("fastqr", dict(method="cholqr2")),
    "fastqr_cholqr3": ("fastqr", dict(method="cholqr3")),
    "tsqr": ("tsqr", {}),
    "qr": ("qr", {}),
    "qr_auto_fused": ("qr_auto_fused", {}),
}


def _inputs(m, n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-1, 1, s).astype(np.float32)
            for s in ((m, n), (m, n), (n, n), (m, n))]


def _rel(x, ref) -> float:
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _torch_fn(name):
    entry, kw = ENTRIES[name]
    fn = getattr(tsqr_tpu_torch, entry)
    return lambda x: fn(x, "fp32", device="cpu", **kw)


def _jax_fn(name):
    entry, kw = ENTRIES[name]
    fn = getattr(tsqr_tpu, entry)
    return lambda x: fn(x, "fp32", **kw)


@pytest.mark.parametrize("shape", [(512, 16), (96, 12)])
@pytest.mark.parametrize("name", list(ENTRIES))
def test_grad_matches_jax(name, shape):
    a, w, v, _ = _inputs(*shape)
    at = torch.from_numpy(a).requires_grad_()
    q, r = _torch_fn(name)(at)
    assert q.grad_fn is not None and r.grad_fn is not None
    loss = (q * torch.from_numpy(w)).sum() + (r * torch.from_numpy(v)).sum()
    (g,) = torch.autograd.grad(loss, at)

    def jloss(x):
        qj, rj = _jax_fn(name)(x)
        return jnp.sum(qj * w) + jnp.sum(rj * v)

    g_ref = jax.grad(jloss)(jnp.asarray(a))
    assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
    assert _rel(g, g_ref) <= TOL, name


@pytest.mark.parametrize("name", ["fastqr_cholqr2", "tsqr", "qr_auto_fused"])
def test_jvp_matches_jax(name):
    a, _, _, da = _inputs(96, 12, seed=1)
    (q, r), (dq, dr) = torch.func.jvp(_torch_fn(name), (torch.from_numpy(a),),
                                      (torch.from_numpy(da),))
    (qj, rj), (dqj, drj) = jax.jvp(_jax_fn(name), (jnp.asarray(a),),
                                   (jnp.asarray(da),))
    assert _rel(q, qj) <= TOL and _rel(r, rj) <= TOL
    assert _rel(dq, dqj) <= TOL and _rel(dr, drj) <= TOL
    # the forward-mode API agrees with torch.func
    import torch.autograd.forward_ad as fwad
    with fwad.dual_level():
        dual = fwad.make_dual(torch.from_numpy(a), torch.from_numpy(da))
        q2, _ = _torch_fn(name)(dual)
        assert _rel(fwad.unpack_dual(q2).tangent, dqj) <= TOL


def test_second_order_matches_jax():
    # grad of grad through fastqr(cholqr2), as tests/test_autodiff.py
    # takes the JAX package's hessian through the same entry
    a = np.random.default_rng(10).uniform(-1, 1, (32, 6)).astype(np.float32)

    def tloss(x):
        _, r = tsqr_tpu_torch.fastqr(x, "fp32", "cholqr2", device="cpu")
        return (r ** 3).sum()

    at = torch.from_numpy(a).requires_grad_()
    (g,) = torch.autograd.grad(tloss(at), at, create_graph=True)
    (gg,) = torch.autograd.grad((g ** 2).sum(), at)

    def jloss(x):
        _, r = tsqr_tpu.fastqr(x, "fp32", method="cholqr2")
        return jnp.sum(r ** 3)

    gg_ref = jax.grad(lambda x: jnp.sum(jax.grad(jloss)(x) ** 2))(
        jnp.asarray(a))
    assert _rel(gg, gg_ref) <= TOL


def test_gradcheck_of_the_rule_around_a_float64_qr():
    # the rule alone, around torch.linalg.qr in float64: gradcheck holds
    # qr_adjoint (backward) and qr_tangent (forward) to finite
    # differences; both compute in float32, as JAX's, well inside
    # gradcheck's 1e-3 relative tolerance
    f = diff.differentiable(lambda a, device="cpu": torch.linalg.qr(a))
    a = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (20, 5)))
    assert torch.autograd.gradcheck(f, (a.requires_grad_(),),
                                    check_forward_ad=True)


def test_adjoint_and_tangent_are_transposes():
    # <dA, qr_adjoint(dQ, dR)> = <qr_tangent(dA), (dQ, dR)>, dR upper
    rng = np.random.default_rng(4)
    q, r = torch.linalg.qr(torch.from_numpy(
        rng.uniform(-1, 1, (64, 8)).astype(np.float32)))
    da, dq = (torch.from_numpy(rng.uniform(-1, 1, (64, 8)).astype(np.float32))
              for _ in range(2))
    dr = torch.triu(torch.from_numpy(
        rng.uniform(-1, 1, (8, 8)).astype(np.float32)))
    tq, tr = diff.qr_tangent(q, r, da)
    lhs = float((da * diff.qr_adjoint(q, r, dq, dr)).sum())
    rhs = float((tq * dq).sum() + (tr * dr).sum())
    assert abs(lhs - rhs) <= 1e-5 * abs(rhs)


def test_unless_paths_return_what_they_did():
    a = torch.from_numpy(_inputs(96, 12)[0])
    out = tsqr_tpu_torch.qr_auto_fused(a, "fp32", return_info=True,
                                       device="cpu")
    assert len(out) == 3 and out[2]["tier"] == 1
    q, r = tsqr_tpu_torch.tsqr(a, "fp32", want_q=False, device="cpu")
    assert q is None and r.shape == (12, 12)
    q, r, levels = tsqr_tpu_torch.tsqr(a, "fp32", collect_level_q=True,
                                       device="cpu")
    assert q.shape == (96, 12) and isinstance(levels, list)
    # unwrapped: no rule attached, as before the rule existed
    q, r, _ = tsqr_tpu_torch.qr_auto_fused(a.requires_grad_(), "fp32",
                                           return_info=True, device="cpu")
    assert q.grad_fn is None or "EntryQR" not in type(q.grad_fn).__name__


def test_bf16_io_tangents_take_the_outputs_dtype():
    a, w, _, da = _inputs(96, 12, seed=5)
    at = torch.from_numpy(a).requires_grad_()
    q, r = tsqr_tpu_torch.fastqr(at, "bf16", "cholqr2", device="cpu")
    assert q.dtype == r.dtype == torch.bfloat16
    (g,) = torch.autograd.grad((q.float() * torch.from_numpy(w)).sum(), at)
    assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
    _, (dq, dr) = torch.func.jvp(
        lambda x: tsqr_tpu_torch.fastqr(x, "bf16", "cholqr2", device="cpu"),
        (torch.from_numpy(a),), (torch.from_numpy(da),))
    assert dq.dtype == dr.dtype == torch.bfloat16


def test_cpu_tensor_gets_its_gradient_through_the_device_move():
    a, w, _, _ = _inputs(96, 12, seed=6)
    at = torch.from_numpy(a).requires_grad_()
    ad = at.to(torch.float64)   # a differentiable move before the entry
    q, _ = tsqr_tpu_torch.qr(ad, "fp32", device="cpu")
    ((q.float() * torch.from_numpy(w)).sum()).backward()
    assert at.grad is not None and at.grad.device.type == "cpu"
    assert bool(torch.isfinite(at.grad).all())
    # a numpy input is placed and factored, with no gradient to give
    q, _ = tsqr_tpu_torch.fastqr(a, "fp32", device="cpu")
    assert q.grad_fn is None or not q.requires_grad


def test_rule_only_where_something_is_differentiated():
    # without a gradient or a tangent to carry the entry runs as it is
    # (the rule's bookkeeping costs host time on every call)
    a = torch.from_numpy(_inputs(96, 12)[0])
    q, r = tsqr_tpu_torch.fastqr(a, "fp32", device="cpu")
    assert q.grad_fn is None and r.grad_fn is None
    with torch.no_grad():
        q, _ = tsqr_tpu_torch.qr(a.clone().requires_grad_(), "fp32",
                                 device="cpu")
    assert q.grad_fn is None
    q, _ = tsqr_tpu_torch.qr(a.clone().requires_grad_(), "fp32",
                             device="cpu")
    assert "EntryQR" in type(q.grad_fn).__name__
    # ``a`` by keyword is looked at the same way
    q, _ = tsqr_tpu_torch.fastqr(a=a.clone().requires_grad_(), mode="fp32",
                                 device="cpu")
    assert "EntryQR" in type(q.grad_fn).__name__
    q, _ = tsqr_tpu_torch.fastqr(a=a, mode="fp32", device="cpu")
    assert q.grad_fn is None


@pytest.mark.parametrize("entry", ["fastqr", "tsqr", "qr", "qr_auto_fused"])
def test_wrapped_entry_is_the_plain_entry(entry):
    # harness.stream_calls times each exported entry against its
    # ``__wrapped__``: the same factors, with no rule attached
    a = torch.from_numpy(_inputs(96, 12, seed=7)[0]).requires_grad_()
    fn = getattr(tsqr_tpu_torch, entry)
    q, r = fn(a, "fp32", device="cpu")
    with torch.no_grad():
        q0, r0 = fn.__wrapped__(a, "fp32", device="cpu")
    assert "EntryQR" in type(q.grad_fn).__name__
    assert q0.grad_fn is None and r0.grad_fn is None
    assert torch.equal(q.detach(), q0) and torch.equal(r.detach(), r0)
