"""Fixtures of the benchmark's tests (helpers: tiny.py)."""

from __future__ import annotations

import pytest

from tiny import make_root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.fixture()
def cpu_threads():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
