"""Fixtures of the benchmark's tests."""

import pytest

from qrbench.tests import _helpers


@pytest.fixture(scope="session")
def roots(tmp_path_factory):
    """workload -> the root to run it from: the repository, or for the
    four-chip cell a copy that holds it (``_helpers.rows4_root``)."""
    rows4 = _helpers.rows4_root(tmp_path_factory.mktemp("rows4"))
    return lambda workload: rows4 if workload == _helpers.ROWS4 \
        else _helpers.ROOT
