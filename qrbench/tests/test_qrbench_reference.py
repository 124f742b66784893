"""The plain reference: independent of the program, right on known
factors, and in agreement with the port's plain versions (``device="cpu"``)
at a small size for both mixes."""

import ast
import math

import numpy as np
import pytest
import torch

from qrbench import cell as cell_mod, loop, reference
from qrbench.tests._helpers import ROOT

PLAIN = ["reference.py", "arith.py", "generate.py"]


@pytest.mark.parametrize("name", PLAIN)
def test_plain_modules_import_nothing_of_the_program(name):
    tree = ast.parse((ROOT / "qrbench" / name).read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert not tops & {"tsqr_tpu_torch", "tsqr_tpu", "jax", "jaxlib"}


def test_r_factor_matches_numpy():
    rng = np.random.default_rng(4)
    a = rng.uniform(-1, 1, (1000, 24))
    r = reference.r_factor(torch.from_numpy(a), block_rows=128)
    want = np.linalg.qr(a, mode="r")
    want = want * np.where(np.diag(want) < 0, -1.0, 1.0)[:, None]
    assert np.allclose(r.numpy(), want, atol=1e-12)


def test_judge_reads_exact_factors_as_zero_and_wrong_ones_as_not():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.uniform(-1, 1, (512, 16)))
    q, r = torch.linalg.qr(a)
    good = reference.judge(a, q, r, block_rows=100)
    assert max(good.values()) < 1e-13
    bad = reference.judge(a, a, torch.eye(16, dtype=a.dtype))
    assert bad["orth"] > 1 and bad["r_err"] > 0.5
    flipped = q.clone()
    flipped[7] = -flipped[7]
    assert reference.judge(a, flipped, r)["resid"] > 1e-2


def test_judge_compares_only_the_unique_rows_of_r():
    rng = np.random.default_rng(6)
    a = torch.from_numpy(rng.uniform(-1, 1, (256, 8)))
    a[:, 3] = 0
    q, r = torch.linalg.qr(a)
    r2 = r.clone()
    r2[5:, 5:] += 1.0   # rows below the zero column are not unique
    out = reference.judge(a, q, r2, zero_columns=[3])
    assert out["r_err"] < 1e-13
    assert reference.judge(a, q, r, zero_columns=[0])["r_err"] is None


@pytest.mark.parametrize("workload", ["tall128.well", "tall128.rankdef",
                                      "wide1024.well"])
def test_port_plain_versions_pass_the_reference(workload):
    """The port on the CPU (the kernels' plain versions) at a small size,
    judged by the reference: within the cell's limits."""
    c = cell_mod.find(workload)
    c.config["m"], c.config["inputs"] = 4096, 2
    res = loop.run_process(c, 2_200_000_001, 0.0, False,
                           torch.device("cpu"), 0.0)
    assert len(res["judged"]) == 2
    for numbers in res["judged"]:
        for name, limit in c.limits.items():
            assert numbers[name] is not None and math.isfinite(numbers[name])
            assert numbers[name] <= limit, (name, numbers)
