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
from typing import Sequence

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
    preprocessor ``defines``) lives.  The hash covers the shared headers
    ``csrc/*.cuh`` too."""
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(defines)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str], defines: tuple[str, ...] = ()) -> None:
    """Build the missing libraries of ``csrc/<name>.cu`` for ``names``,
    one ``nvcc`` each, all started together.  The compiler's report
    (registers, shared memory, spills) is kept beside each library as
    ``.log``."""
    jobs = []
    for name in names:
        out = library_path(name, defines)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [_nvcc(), *_flags(defines), "-o", str(tmp),
             str(_CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((name, out, tmp, proc, time.perf_counter()))
    failed = []
    for name, out, tmp, proc, t0 in jobs:
        stdout, stderr = proc.communicate()
        out.with_suffix(".log").write_text(stdout + stderr)
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{stderr}")
            continue
        os.replace(tmp, out)
        BUILD_SECONDS[" ".join((name, *defines))] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it."""
    key = " ".join((name, *defines))
    if key in _LIBS:
        return _LIBS[key]
    build((name,), defines)
    lib = ctypes.CDLL(str(library_path(name, defines)))
    _LIBS[key] = lib
    return lib
