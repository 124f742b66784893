"""Run provenance and small printing helpers for the harness.

Counterpart of ``tsqr_tpu/utils/status.py``: ``print_banner`` gives the
git branch and commit, the date, the torch version and the card's name
and power limit; ``exc_note`` makes one CSV-safe line of an exception;
``print_matrix`` dumps a labelled corner of a matrix.
"""

from __future__ import annotations

import datetime
import subprocess
import sys


def _run(*cmd: str) -> str:
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=10).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or
    "no card"."""
    lines = _run("nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader").splitlines()
    return lines[0] if lines and lines[0] != "unknown" else "no card"


def print_matrix(a, name: str = "", file=sys.stdout,
                 max_rows: int = 32, max_cols: int = 16) -> None:
    """A labelled dump of the top-left ``max_rows`` x ``max_cols`` of a
    matrix (a batch of tiles is flattened per row)."""
    import numpy as np
    import torch

    if isinstance(a, torch.Tensor):
        a = a.detach().to("cpu", torch.float64).numpy()
    a = np.asarray(a)
    if name:
        print(f"# {name} {a.shape} {a.dtype}", file=file)
    if a.ndim == 0:
        a = a.reshape(1, 1)
    elif a.ndim == 1:
        a = a.reshape(-1, 1)
    elif a.ndim > 2:
        a = a.reshape(a.shape[0], -1)
    r, c = a.shape
    for row in a[:max_rows, :max_cols]:
        print(" ".join(f"{v:+.4e}" for v in row), file=file)
    if r > max_rows or c > max_cols:
        print(f"# ... truncated to {max_rows}x{max_cols}", file=file)


def exc_note(e: BaseException, limit: int = 200) -> str:
    """One line for a CSV sweep's '# error' row: the exception's type and
    its message with all whitespace folded, cut at ``limit``."""
    return f"{type(e).__name__}: " + " ".join(str(e).split())[:limit]


def print_banner(file=sys.stderr) -> None:
    import torch

    branch = _run("git", "rev-parse", "--abbrev-ref", "HEAD") or "unknown"
    commit = _run("git", "rev-parse", "--short", "HEAD") or "unknown"
    print(f"# tsqr_tpu_torch  branch={branch} commit={commit}", file=file)
    print(f"# date={datetime.datetime.now().isoformat(timespec='seconds')} "
          f"torch={torch.__version__} cuda={torch.version.cuda} "
          f"card={card_line()}", file=file)
