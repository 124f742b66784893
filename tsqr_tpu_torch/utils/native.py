"""ctypes loader for the native C++ emulation cores (``csrc/emu_gemm.cpp``).

Counterpart of ``tsqr_tpu/utils/native.py``, over the port's own copy of
the source: products with operand mantissas clipped to a width (bf16 = 7
bits, tf32 = 10) and the split correction, computed on the host in C++,
an independent golden for ``modes.clip_mantissa`` and the ``mm_*_emu``
products.  A host library, not a kernel of the card: it is built with
``g++ -O2 -shared -fPIC`` at first use into ``ops/build/`` (named by a
hash of the source, so an edited source builds anew), and bound through
a plain C ABI.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np

_SRC = pathlib.Path(__file__).resolve().parent / "csrc" / "emu_gemm.cpp"
_BUILD = pathlib.Path(__file__).resolve().parents[1] / "ops" / "build"
_FLAGS = ("-O2", "-shared", "-fPIC")

_lib = None


def library_path() -> pathlib.Path:
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return _BUILD / f"emu_gemm-{h.hexdigest()[:16]}.so"


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib_path = library_path()
    if not lib_path.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
                       check=True)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    fp = ctypes.POINTER(ctypes.c_float)
    for name in ("emu_gemm_nocor", "emu_gemm_cor", "emu_gemm_mixed"):
        fn = getattr(lib, name)
        fn.argtypes = [fp, fp, fp, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int]
        fn.restype = None
    lib.emu_clip_mantissa.argtypes = [ctypes.c_float, ctypes.c_int]
    lib.emu_clip_mantissa.restype = ctypes.c_float
    _lib = lib
    return lib


def _gemm(name: str, a, b, bits: int) -> np.ndarray:
    lib = _load()
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name}: shapes {a.shape} and {b.shape} do not "
                         "multiply")
    m, k = a.shape
    n = b.shape[1]
    c = np.empty((m, n), np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    getattr(lib, name)(a.ctypes.data_as(fp), b.ctypes.data_as(fp),
                       c.ctypes.data_as(fp), m, n, k, bits)
    return c


def emu_gemm_nocor(a, b, bits: int = 7) -> np.ndarray:
    """A B with both operands clipped to ``bits`` mantissa bits."""
    return _gemm("emu_gemm_nocor", a, b, bits)


def emu_gemm_cor(a, b, bits: int = 7) -> np.ndarray:
    """The split-corrected product hi hi + (hi lo + lo hi), every part
    clipped to ``bits``."""
    return _gemm("emu_gemm_cor", a, b, bits)


def emu_gemm_mixed(a, b, bits: int = 7) -> np.ndarray:
    """The split-corrected product with unclipped low parts."""
    return _gemm("emu_gemm_mixed", a, b, bits)


def clip_mantissa_scalar(x: float, bits: int) -> float:
    return float(_load().emu_clip_mantissa(ctypes.c_float(x), bits))
