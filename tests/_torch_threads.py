"""The thread budget of a test process: every BLAS and OpenMP pool at
``THREADS`` threads.

The suite runs under ``pytest -n 6`` on a machine of a few cores.  Left
alone, each worker's numpy OpenBLAS, torch's OpenMP pool and the OpenBLAS
that jaxlib's CPU LAPACK calls each start one thread a core, and six
workers' pools oversubscribe the machine: on 8 cores a (2064, 2056)
``np.linalg.qr`` that takes ~1 s at one or two threads took ~57 s beside
a running suite.  ``torch.set_num_threads`` caps torch's pool alone, so
the cap is made here, once, with ``threadpoolctl`` over every pool loaded
in the process.

A port test module imports this module (``import _torch_threads``) before
its first linear algebra.  The import loads every pool first: numpy's,
torch's, and scipy's OpenBLAS, which ``scipy.linalg`` loads and jaxlib's
LAPACK kernels call; a pool loaded after the cap would not be capped.  It
runs no JAX operation: JAX must initialise its backend under
``tests/conftest.py``, which forces the 8 host devices first.

Every xdist worker imports every collected test module before it runs a
case, so the cap holds for the whole worker: the JAX package's test files
run under it too, although they do not import this module.
"""

import jax  # noqa: F401
import numpy  # noqa: F401
import scipy.linalg  # noqa: F401
import threadpoolctl
import torch

THREADS = 2

torch.set_num_threads(THREADS)
threadpoolctl.threadpool_limits(THREADS)
