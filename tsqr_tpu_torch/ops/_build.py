"""Build and load the package's CUDA kernels.

The sources under ``ops/csrc`` are compiled with ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``.
The library goes into ``ops/build/`` (listed in ``.gitignore``), named by
a hash of the sources and flags, so an edited source builds anew and an
unchanged one is built once.  Nothing is built at import: the first call
that launches a kernel builds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_SECONDS: dict[str, float] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def _flags(defines: tuple[str, ...]) -> list[str]:
    return [*FLAGS, *(f"-D{d}" for d in defines)]


def library_path(name: str, defines: tuple[str, ...] = ()) -> Path:
    """Where the library built from ``csrc/<name>.cu`` (with the given
    preprocessor ``defines``) lives."""
    src = _CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(_flags(defines)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it.
    The compiler's report (registers, shared memory, spills) is kept
    beside the library as ``.log``."""
    key = " ".join((name, *defines))
    if key in _LIBS:
        return _LIBS[key]
    out = library_path(name, defines)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [_nvcc(), *_flags(defines), "-o", str(tmp),
             str(_CSRC / f"{name}.cu")],
            capture_output=True, text=True)
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
        os.replace(tmp, out)
        BUILD_SECONDS[key] = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    _LIBS[key] = lib
    return lib
