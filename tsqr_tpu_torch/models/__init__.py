"""Application models built on the QR stack, in PyTorch.

Counterpart of ``tsqr_tpu/models``: the factorization's standard
consumers, each routing its m-scale work through the port's QR entry
points (the stream kernel through the ladder and ``fastqr``'s fused
methods, the panel kernel through ``tsqr`` and ``qr``).  Every entry
runs on the card unless ``device="cpu"``; a random one takes a
``torch.Generator`` on that device where JAX takes a key.  ``mesh=``
runs an entry over a process mesh (``tsqr_tpu_torch.parallel``): its
inputs are the rank's row shards, its QRs the distributed drivers.

  * :func:`tsqr_svd`: deterministic thin SVD (QR + small SVD).
  * :func:`rsvd`: randomized SVD (sketch + TSQR orthogonalization).
  * :func:`block_lanczos`: block Lanczos with TSQR orthogonalization.
  * :func:`lstsq`: least squares via BlockQR (+ ridge via stacked QR).
  * :func:`lstsq_cgls`: matrix-free least squares, sketch-
    preconditioned CGLS (``lstsq_regen``, over the streamed QR, is in
    ``models.lstsq``).
  * :func:`pivoted_qr`: rank-revealing QR (randomized column pivots).
  * :func:`interpolative` / :func:`cur`: column ID and CUR skeletons.
  * :func:`polar` / :func:`procrustes`: QDWH polar decomposition and the
    orthogonal Procrustes rotation.
  * :func:`subspace_iteration` / :func:`nystrom`: top-k symmetric
    eigenpairs and one-shot randomized PSD approximation.
  * :func:`cca`: canonical correlation analysis (Björck–Golub).
"""

from tsqr_tpu_torch.models.svd import tsqr_svd
from tsqr_tpu_torch.models.rsvd import rsvd
from tsqr_tpu_torch.models.lanczos import block_lanczos
from tsqr_tpu_torch.models.lstsq import lstsq, lstsq_cgls
from tsqr_tpu_torch.models.qrcp import pivoted_qr, interpolative, cur
from tsqr_tpu_torch.models.polar import polar, procrustes
from tsqr_tpu_torch.models.subspace import subspace_iteration, nystrom
from tsqr_tpu_torch.models.cca import cca

__all__ = ["tsqr_svd", "rsvd", "block_lanczos", "lstsq", "lstsq_cgls",
           "pivoted_qr", "interpolative", "cur",
           "polar", "procrustes", "subspace_iteration", "nystrom",
           "cca"]
