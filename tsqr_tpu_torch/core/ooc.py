"""Out-of-core tall-skinny QR: m too large for the card's memory.

Counterpart of ``tsqr_tpu/core/ooc.py``.  The reference benchmarks m up
to 2^26: at n = 128 that is 34 GB (float32) / 17 GB (bf16) for A alone.
The Gram-based methods stream naturally: G = sum of per-chunk
A_c^T A_c needs one (chunk, n) tile on the device at a time, and each Q
chunk is independent given R.  Two drivers:

* :func:`qr_out_of_core` keeps A in host memory, streams its chunks to
  the device through a pair of reused pinned staging buffers, and
  writes Q chunks back the same way (host memory stays bounded by
  construction: two chunks of staging a direction), with an optional
  checkpoint that makes the factorization resumable across the death of
  the process;
* :func:`qr_regen` never stores A at all: a generator makes chunk i
  again in every pass, on the device.

Passes over A: cholqr1 = 2 reads + 1 write; cholqr2 = 5; cholqr3 = 7 —
the on-device pipelines' pass structure, with host transfers for
device-memory ones.

The Grams and products are ``modes.gram`` and ``Policy.mm``, the split
products in plain float32 PyTorch matmuls, as the JAX module leaves them
to XLA; no kernel of ``ops/`` runs here.  One difference of order: a
chunk's Gram (:func:`_gram`) sums its products over ``GRAM_BLOCK``-row
blocks in float32 and the blocks in float64, as the stream kernel's
float32 chunks with float64 partials do, so that the summation error
stays local to 4096 rows whatever the chunk.  On an H100 at 700 W
(``harness/precision.py``) a float32 Gram of a uniform (2^22, 128) A is
7.5e-7 off float64 in one product and 1.1e-7 in blocks; the product of
its leading bf16 split part with itself is 7.7e-6 off either way, and it
floors Q of ``qr_regen`` at (2^22, 128) at 7.2e-6 orthogonality in
``bf16x6_cor`` (``fp32``: 9.7e-8), as it floors the non-fused methods'
split Grams.  The metrics
stream too (:func:`ooc_orthogonality`, :func:`ooc_residual`),
Kahan-compensated across chunks.

Host arrays: ``a`` and ``out`` are numpy arrays or CPU tensors.  numpy
has no bfloat16, so an array of the ``bf16`` mode's io dtype is a CPU
``torch.bfloat16`` tensor; a disk-backed one is a ``uint16``
``np.memmap`` viewed through ``torch.from_numpy(mm).view(torch.bfloat16)``.
"""

from __future__ import annotations

import os
import pathlib
import warnings
from typing import Callable

import numpy as np
import torch

from tsqr_tpu_torch import modes
from tsqr_tpu_torch.core import cholqr
from tsqr_tpu_torch.utils import device as _device

Tensor = torch.Tensor

_N_ITERS = {"cholqr1": 1, "cholqr2": 2, "cholqr3": 3}
# rows of a block whose Gram products are summed in float32 (_gram)
GRAM_BLOCK = 4096
_FP32 = modes.resolve("fp32")


class OOCInterrupted(RuntimeError):
    """Raised by the fault-injection hook after a checkpoint was saved:
    a controlled failure at an exact chunk boundary, used to test that
    resume reproduces the uninterrupted run."""


def _chunks(m: int, chunk: int):
    for lo in range(0, m, chunk):
        yield lo, min(lo + chunk, m)


def _kahan_add(g, comp, contrib):
    y = contrib - comp
    t = g + y
    return t, (t - g) - y


def _gram(x: Tensor, policy: modes.Policy) -> Tensor:
    """``modes.gram`` of a float32 chunk, summed over GRAM_BLOCK-row
    blocks in float32 (one batched product) and across the blocks in
    float64, rounded to float32."""
    rows, n = x.shape
    full = rows - rows % GRAM_BLOCK
    g = torch.zeros(n, n, dtype=torch.float64, device=x.device)
    if full:
        blocks = x[:full].reshape(full // GRAM_BLOCK, GRAM_BLOCK, n)
        g = g + modes.gram(blocks, policy).to(torch.float64).sum(0)
    if full < rows:
        g = g + modes.gram(x[full:], policy).to(torch.float64)
    return g.to(torch.float32)


def _method_iters(method: str, allowed) -> int | None:
    if method not in allowed:
        raise ValueError(f"unknown method {method!r}; expected one of "
                         f"{sorted(allowed)}")
    return allowed[method]


# ---- matrix-free streamed QR -------------------------------------------------

def qr_regen(gen_chunk: Callable[[int], Tensor], m: int, n: int,
             mode="bf16", method: str = "cholqr2",
             chunk_rows: int = 1 << 21, device=None) -> tuple[Tensor, dict]:
    """Matrix-free streamed QR: A is defined by a generator and never
    materialized — the route to the reference's m = 2^26 envelope edge
    with A made on the device.

    ``gen_chunk(i)`` returns chunk ``i`` of A, shape ``(chunk_rows, n)``,
    as a tensor on the call's device (the card unless ``device="cpu"``);
    it is called again in every pass, so chunk ``i`` must be the same
    bits each time (:func:`uniform_gen`).  Q is never stored: the final
    pass forms each Q chunk, folds it into the metrics
    (Kahan-compensated Q^T Q and the relative residual) and drops it; a
    consumer wanting Q applies ``info["rinv"]`` to its own chunks (one
    product).  Iterations compose in float32; Q is rounded to the
    policy's io dtype only in the metrics pass.  ``method``: "cholqr1",
    "cholqr2", "cholqr3" or "cholqr_iter" (corrected/fp32 modes).

    Returns ``(r, info)`` with ``info = {orthogonality, residual, rinv}``
    (the metrics as 0-dim tensors on the device: reading them is the
    call's only host sync besides the cholqr_iter loop's)."""
    r, orth, resid, rinv = regen_program(gen_chunk, m, n, mode, method,
                                         chunk_rows, device=device)()
    return r, {"orthogonality": orth, "residual": resid, "rinv": rinv}


def regen_program(gen_chunk: Callable[[int], Tensor], m: int, n: int,
                  mode="bf16", method: str = "cholqr2",
                  chunk_rows: int = 1 << 21,
                  device=None) -> Callable[[], tuple]:
    """The nullary program behind :func:`qr_regen`: every argument is
    checked and resolved once here, so a benchmark calls it repeatedly
    without set-up in the timed window.  Returns
    () -> (r, orth, resid, rinv_total)."""
    policy = modes.resolve(mode)
    dev = _device.resolve(device, "qr_regen")
    if m % chunk_rows:
        raise ValueError(f"chunk_rows={chunk_rows} must divide m={m}")
    _method_iters(method, {**_N_ITERS, "cholqr_iter": None})
    n_chunks = m // chunk_rows

    def run():
        return _regen_body(gen_chunk, n_chunks, n, chunk_rows, policy,
                           method, device=dev)

    return run


def _regen_body(gen_chunk: Callable[[int], Tensor], n_chunks: int, n: int,
                chunk_rows: int, policy: modes.Policy, method: str,
                reduce: Callable[[Tensor], Tensor] = lambda x: x, *,
                device: torch.device,
                agree: Callable[[bool], bool] = bool) -> tuple[
                    Tensor, Tensor, Tensor, Tensor]:
    """The core of :func:`qr_regen`: (r, orth, resid, rinv_total).

    ``reduce`` wraps every cross-chunk (n, n) or scalar accumulation:
    the identity here; an all-reduce over the process group where each
    process runs this body over its own chunk range
    (``parallel.dtsqr.dqr_regen``), so that the reduced Gram and metric
    accumulators are the only communication.  ``agree`` makes each exit
    test of the cholqr_iter loop one decision of every rank."""
    n_iters = _method_iters(method, {**_N_ITERS, "cholqr_iter": None})
    dev = torch.device(device)
    f32 = torch.float32
    eye = torch.eye(n, dtype=f32, device=dev)

    def chunk(i):
        return gen_chunk(i).to(device=dev, dtype=f32)

    def gram_pass(rinv_total):
        g = torch.zeros(n, n, dtype=f32, device=dev)
        comp = torch.zeros_like(g)
        for i in range(n_chunks):
            x = chunk(i)
            if rinv_total is not None:
                x = policy.mm(x, rinv_total)
            g, comp = _kahan_add(g, comp, _gram(x, policy))
        return reduce(g)

    if method == "cholqr_iter":
        # the iterated shifted loop with the regenerating Gram: each pass
        # is one streamed regeneration of A
        if policy.mode in cholqr._CHEAP_DOT:
            # a bf16-grade Gram's noise floor defeats both exit signals:
            # the loop would burn max_shifted full regenerations
            raise ValueError(
                "qr_regen(method='cholqr_iter'): the cheap-dot modes' "
                "Gram noise floor defeats the shifted-contraction "
                f"analysis; use corrected/fp32 modes (got "
                f"{policy.mode.value!r})")
        g0 = gram_pass(None)
        g0 = (g0 + g0.T) * 0.5

        def gram_of_f(f):
            g = gram_pass(f)
            return (g + g.T) * 0.5

        f, rt, g, _, _ = cholqr._iter_shifted_loop(
            g0, gram_of_f,
            lambda gg: cholqr._shift_value_fused(gg, n, chunk_rows),
            n, cholqr._iter_polish_k2(policy), 16, agree)
        # the tail factor is applied as a second product in the metrics
        # pass, to the bitwise-recomputed x F (composing it into F would
        # floor orthogonality at ~eps kappa(A))
        r2 = cholqr._chol_r(g)
        rinv_tail = cholqr._rinv(r2)
        rinv_total, r_total = f, modes.mm_fp32(r2, rt)
    else:
        rinv_tail = rinv_total = None
        r_total = eye
        for it in range(n_iters):
            g = gram_pass(rinv_total)
            shift = (cholqr._shift_value_fused(g, n, chunk_rows)
                     if it == 0 and method == "cholqr3" else 0.0)
            r = cholqr._chol_r(g, shift=shift)
            rinv = cholqr._rinv(r)
            rinv_total = (rinv if rinv_total is None
                          else modes.mm_fp32(rinv_total, rinv))
            r_total = modes.mm_fp32(r, r_total)

    qtq = torch.zeros(n, n, dtype=f32, device=dev)
    comp = torch.zeros_like(qtq)
    d2 = torch.zeros((), dtype=f32, device=dev)
    a2 = torch.zeros_like(d2)
    for i in range(n_chunks):
        x = chunk(i)
        q = policy.mm(x, rinv_total)
        if rinv_tail is not None:
            q = policy.mm(q, rinv_tail)
        q32 = q.to(policy.io_dtype).to(f32)
        qtq, comp = _kahan_add(qtq, comp, _gram(q32, _FP32))
        d = x - modes.mm_fp32(q32, r_total)
        d2 = d2 + torch.sum(d * d)
        a2 = a2 + torch.sum(x * x)
    qtq, d2, a2 = reduce(qtq), reduce(d2), reduce(a2)
    orth = torch.linalg.norm(qtq - eye) / n ** 0.5
    resid = torch.sqrt(d2) / torch.sqrt(a2)
    if rinv_tail is not None:
        # consumers apply ONE factor to their own chunks; the metrics
        # above report the two-product path
        rinv_total = modes.mm_fp32(rinv_total, rinv_tail)
    return torch.triu(r_total), orth, resid, rinv_total


def _chunk_seed(seed: int, i: int) -> int:
    """Chunk i's generator seed: a fixed derivation of (seed, i), the
    same in every process and independent of the order of draws."""
    return int(np.random.SeedSequence([seed, i]).generate_state(
        1, np.uint64)[0])


def uniform_gen(seed: int, chunk_rows: int, n: int,
                dtype: torch.dtype = torch.bfloat16,
                device=None) -> Callable[[int], Tensor]:
    """Standard benchmark generator: chunk i = uniform(-1, 1) in float32
    from its own generator on the device, seeded from ``(seed, i)``
    through ``np.random.SeedSequence``, then cast to ``dtype`` —
    deterministic, independent of the order chunks are drawn in, and
    the same bits in every pass.  The values are not the JAX package's
    (its chunk i is ``fold_in(key, i)``): the same seed makes another
    matrix of the same distribution."""
    dev = _device.resolve(device, "uniform_gen")

    def gen(i):
        g = torch.Generator(device=dev).manual_seed(_chunk_seed(seed, i))
        x = torch.empty(chunk_rows, n, dtype=torch.float32, device=dev)
        return x.uniform_(-1.0, 1.0, generator=g).to(dtype)

    return gen


# ---- host-streamed QR ----------------------------------------------------------

def _host_tensor(x, what: str) -> Tensor:
    """A CPU tensor on the memory of a numpy array or CPU tensor."""
    if isinstance(x, Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"{what} must be in host memory, got a tensor "
                             f"on {x.device}")
        return x
    with warnings.catch_warnings():
        # a read-only memmap: this module never writes through `a`
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.asarray(x))


class _Staging:
    """Chunk transfers between host memory and the device through a pair
    of reused pinned buffers a direction (on the CPU: plain copies).

    ``h2d`` copies a host chunk into the next buffer (on the host, while
    the device works on the previous chunk) and starts its asynchronous
    upload; a buffer is reused only once its last upload has completed.
    ``d2h`` starts a chunk's download into the next buffer and copies the
    buffer's previous chunk out to its host rows once that download has
    completed; ``flush`` finishes every pending download."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.pinned = dev.type == "cuda"
        self.bufs: dict = {}
        self.pending: dict = {}

    def _buf(self, key, rows, n, dtype):
        slot = self.bufs.setdefault(key, [None, None, 0])
        k = slot[2]
        slot[2] ^= 1
        b = slot[k]
        if b is None or b[0].shape[0] < rows or b[0].dtype != dtype:
            b = slot[k] = [torch.empty(rows, n, dtype=dtype, pin_memory=True),
                           None]
        return (key, k), b

    def h2d(self, src: Tensor, lo: int, hi: int) -> Tensor:
        if not self.pinned:
            return src[lo:hi]
        _, b = self._buf("in", hi - lo, src.shape[1], src.dtype)
        if b[1] is not None:
            b[1].synchronize()
        host = b[0][:hi - lo]
        host.copy_(src[lo:hi])
        x = host.to(self.dev, non_blocking=True)
        b[1] = torch.cuda.Event()
        b[1].record()
        return x

    def d2h(self, x: Tensor, dst: Tensor, lo: int, hi: int) -> None:
        if not self.pinned:
            dst[lo:hi].copy_(x)
            return
        key, b = self._buf("out", hi - lo, x.shape[1], x.dtype)
        self._drain(key)
        b[0][:hi - lo].copy_(x, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        self.pending[key] = (ev, b[0][:hi - lo], dst, lo, hi)

    def _drain(self, key) -> None:
        p = self.pending.pop(key, None)
        if p is not None:
            ev, host, dst, lo, hi = p
            ev.synchronize()
            dst[lo:hi].copy_(host)

    def flush(self) -> None:
        for key in sorted(self.pending, key=lambda k: self.pending[k][3]):
            self._drain(key)


def qr_out_of_core(a, mode="fp32", method: str = "cholqr3",
                   chunk_rows: int = 1 << 20, out=None,
                   metrics: bool = False,
                   checkpoint: str | os.PathLike | None = None,
                   _fault_after: int | None = None, device=None):
    """Thin QR of a host-resident (m, n) array, streamed through the card
    (or, with ``device="cpu"``, through the CPU's plain products).

    ``a``: a numpy array or CPU tensor (float32, or a bf16 tensor to
    halve host memory and transfers; each chunk is cast to float32 on
    the device).  Returns (Q, R): Q is ``out`` when given (a numpy array
    or CPU tensor of the mode's io dtype, which may alias ``a`` to halve
    host memory — the host analogue of ``fastqr_inplace``), else a new
    CPU tensor of the io dtype; R is an (n, n) float32 CPU tensor.

    ``metrics=True`` also returns ``{"orthogonality", "residual"}``
    accumulated on the device during the final Q pass, while the input
    chunk and its Q chunk are both resident — no extra pass.  For
    cholqr1 the residual is ||A - QR|| / ||A||; for cholqr2/3 it is the
    last refinement pass's own (measure against intact A with
    :func:`ooc_residual` for the composed one).

    ``checkpoint=<path>`` makes the factorization resumable across the
    death of the process.  A chunk that may have been partly written can
    only be redone from an intact source, so under checkpointing every
    pass derives its input chunk from ``a`` through the stored chain of
    per-iteration R^-1 factors, with the io-dtype rounding of each hop:
    bit for bit the sequential passes over a stored Q.  The checkpoint
    holds only (n, n) accumulators and progress markers, replaced
    atomically (tmp + ``os.replace``) after every chunk, with the JAX
    package's ``.npz`` keys, so either package resumes the other's.
    Intermediate Q passes vanish: checkpointed cholqr{1,2,3} move
    {3,4,5} A-sized transfers.  ``out`` must not alias ``a`` and should
    be disk-backed (``np.memmap``) to survive the process; the file is
    removed on completion.  ``_fault_after=k`` raises
    :class:`OOCInterrupted` after the k-th checkpointed chunk step."""
    policy = modes.resolve(mode)
    dev = _device.resolve(device, "qr_out_of_core")
    n_iters = _method_iters(method, _N_ITERS)
    a_t = _host_tensor(a, "a")
    m, n = a_t.shape
    if m < n:
        raise ValueError(f"qr_out_of_core requires m >= n, got {(m, n)}")
    io = policy.io_dtype
    f32 = torch.float32
    stage = _Staging(dev)

    def gram_fn(x):
        return _gram(x.to(f32), policy)

    def qpass_fn(x, ri):
        return policy.mm(x.to(f32), ri).to(io)

    if out is not None:
        q_host = _host_tensor(out, "out")
        if q_host.dtype != io or tuple(q_host.shape) != (m, n):
            raise ValueError(f"out must be ({m}, {n}) {io}, got "
                             f"{tuple(q_host.shape)} {q_host.dtype}")
    else:
        q_host = torch.empty(m, n, dtype=io)
    src = a_t
    r_total = torch.eye(n, dtype=f32, device=dev)
    qtq = comp_q = d2 = a2 = None

    # ---- checkpoint plumbing (every hook does nothing without one) ----
    use_ck = checkpoint is not None
    state = None
    if use_ck:
        if out is None or q_host.data_ptr() == a_t.data_ptr():
            raise ValueError(
                "checkpointing needs a separate (ideally disk-backed) "
                "`out`: a possibly-partially-written chunk can only be "
                "redone from an intact `a`")
        ckpath = pathlib.Path(checkpoint)
        header = np.array([m, n, n_iters, chunk_rows, int(metrics)],
                          np.int64)
        fp_row0 = a_t[0].to(f32).numpy()  # wrong-input resume guard
        if ckpath.exists():
            z = np.load(ckpath, allow_pickle=False)
            if (not np.array_equal(z["header"], header)
                    or str(z["mode"]) != policy.mode.value
                    or not np.array_equal(z["fp_row0"], fp_row0)):
                raise ValueError(f"checkpoint {ckpath} does not match "
                                 "this call's inputs/config")
            state = {k: z[k] for k in z.files}

    steps = 0
    _zn = torch.zeros(n, n, dtype=f32)

    def _np(x):
        if x is None:
            return np.asarray(0.0, np.float32)
        return x.detach().to("cpu", f32).numpy()

    def _save(it, phase, next_lo, g_a, comp_a, r_a, rinvs):
        # atomic (tmp + rename) after EVERY chunk: ~0.5 MB of (n, n)
        # accumulators against a chunk transfer of hundreds of MB
        nonlocal steps
        if not use_ck:
            return
        tmp = ckpath.with_suffix(".tmp.npz")
        np.savez(
            tmp, header=header, mode=np.asarray(policy.mode.value),
            fp_row0=fp_row0, it=np.int64(it), phase=np.int64(phase),
            chunk=np.int64(next_lo), g=_np(g_a), comp=_np(comp_a),
            r=_np(r_a), r_total=_np(r_total),
            rinvs=(np.stack([_np(x) for x in rinvs]) if rinvs
                   else np.zeros((0, n, n), np.float32)),
            qtq=_np(qtq), comp_q=_np(comp_q), d2=_np(d2), a2=_np(a2))
        os.replace(tmp, ckpath)
        steps += 1
        if _fault_after is not None and steps >= _fault_after:
            raise OOCInterrupted(f"injected fault after {steps} steps")

    def _dev(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    it0 = phase0 = chunk0 = 0
    rinv_devs: list[Tensor] = []
    if state is not None:
        it0, phase0 = int(state["it"]), int(state["phase"])
        chunk0 = int(state["chunk"])
        r_total = _dev(state["r_total"])
        rinv_devs = [_dev(x) for x in state["rinvs"]]

    def _chain_chunk(lo, hi):
        # the CURRENT iteration's input chunk, recomputed from intact A
        # through the completed iterations' R^-1 chain: each hop pays the
        # io-dtype rounding the stored-Q path pays, so the values are
        # bit-identical to the plain sequential passes
        x = stage.h2d(a_t, lo, hi)
        for ri in rinv_devs:
            x = qpass_fn(x, ri)
        return x

    def _in_chunk(lo, hi):
        return _chain_chunk(lo, hi) if use_ck else stage.h2d(src, lo, hi)

    for it in range(it0, n_iters):
        last = it == n_iters - 1
        resume_here = state is not None and it == it0
        if resume_here and phase0 == 1:
            # this iteration's Gram phase completed before the crash; the
            # restored r_total already includes its r
            r = _dev(state["r"])
        else:
            # --- Gram pass over host chunks (Kahan-compensated float32) ---
            if resume_here and phase0 == 0:
                g, comp, c0 = _dev(state["g"]), _dev(state["comp"]), chunk0
            else:
                g = torch.zeros(n, n, dtype=f32, device=dev)
                comp = torch.zeros_like(g)
                c0 = 0
            for lo, hi in _chunks(m, chunk_rows):
                if lo < c0:
                    continue
                g, comp = _kahan_add(g, comp, gram_fn(_in_chunk(lo, hi)))
                _save(it, 0, hi, g, comp, _zn, rinv_devs)
            shift = (cholqr._shift_value(g, m, n)
                     if it == 0 and method == "cholqr3" else 0.0)
            r = cholqr._chol_r(g, shift=shift)
            r_total = modes.mm_fp32(r, r_total)
        rinv = cholqr._rinv(r)
        if use_ck and not last:
            # recompute mode: the intermediate Q never materializes; the
            # next Gram pass derives its chunks from A through the chain
            rinv_devs.append(rinv)
            _save(it + 1, 0, 0, _zn, _zn, _zn, rinv_devs)
            continue
        final = metrics and last
        if final:
            rt = torch.triu(r)
            if resume_here and phase0 == 1:
                qtq, comp_q = _dev(state["qtq"]), _dev(state["comp_q"])
                d2, a2 = _dev(state["d2"]), _dev(state["a2"])
            else:
                qtq = torch.zeros(n, n, dtype=f32, device=dev)
                comp_q = torch.zeros_like(qtq)
                d2 = torch.zeros((), dtype=f32, device=dev)
                a2 = torch.zeros_like(d2)
        # --- Q pass ---
        c0 = chunk0 if (resume_here and phase0 == 1) else 0
        for lo, hi in _chunks(m, chunk_rows):
            if lo < c0:
                continue
            x = _in_chunk(lo, hi)
            qc = qpass_fn(x, rinv)
            if final:
                x32, q32 = x.to(f32), qc.to(f32)
                qtq, comp_q = _kahan_add(qtq, comp_q, _gram(q32, _FP32))
                d = x32 - modes.mm_fp32(q32, rt)
                d2 = d2 + torch.sum(d * d)
                a2 = a2 + torch.sum(x32 * x32)
            stage.d2h(qc, q_host, lo, hi)
            if use_ck:
                stage.flush()  # chunk on the host before it is recorded
            _save(it, 1, hi, _zn, _zn, r, rinv_devs)
        stage.flush()
        src = q_host
    if use_ck and ckpath.exists():
        ckpath.unlink()  # completed: a later call starts fresh
    q_out = out if out is not None else q_host
    r_out = torch.triu(r_total).cpu()
    if not metrics:
        return q_out, r_out
    orth = float(torch.linalg.norm(qtq - torch.eye(n, device=dev))
                 / n ** 0.5)
    resid = float(torch.sqrt(d2) / torch.sqrt(a2))
    return q_out, r_out, {"orthogonality": orth, "residual": resid}


def ooc_orthogonality(q, chunk_rows: int = 1 << 20, device=None) -> float:
    """||Q^T Q - I||_F / sqrt(n) for a host-resident Q, streamed through
    the device with Kahan-compensated Gram accumulation (the measurement
    error is chunk-local, independent of m)."""
    dev = _device.resolve(device, "ooc_orthogonality")
    q_t = _host_tensor(q, "q")
    m, n = q_t.shape
    stage = _Staging(dev)
    g = torch.zeros(n, n, dtype=torch.float32, device=dev)
    comp = torch.zeros_like(g)
    for lo, hi in _chunks(m, chunk_rows):
        x = stage.h2d(q_t, lo, hi).to(torch.float32)
        g, comp = _kahan_add(g, comp, _gram(x, _FP32))
    eye = torch.eye(n, device=dev)
    return float(torch.linalg.norm(g - eye) / n ** 0.5)


def ooc_residual(a, q, r, chunk_rows: int = 1 << 20, device=None) -> float:
    """||A - QR||_F / ||A||_F for host-resident A and Q, chunk-streamed."""
    dev = _device.resolve(device, "ooc_residual")
    a_t, q_t = _host_tensor(a, "a"), _host_tensor(q, "q")
    r_dev = torch.as_tensor(r).to(dev, torch.float32)
    stage_a, stage_q = _Staging(dev), _Staging(dev)
    d2 = torch.zeros((), dtype=torch.float32, device=dev)
    a2 = torch.zeros_like(d2)
    for lo, hi in _chunks(a_t.shape[0], chunk_rows):
        ac = stage_a.h2d(a_t, lo, hi).to(torch.float32)
        qc = stage_q.h2d(q_t, lo, hi).to(torch.float32)
        d = ac - modes.mm_fp32(qc, r_dev)
        d2 = d2 + torch.sum(d * d)
        a2 = a2 + torch.sum(ac * ac)
    return float(torch.sqrt(d2) / torch.sqrt(a2))
