"""pytest settings for the benchmark's own tests: the ``cuda`` marker
(registered here, since ``tests/conftest.py`` imports JAX), and one
intra-op thread for the port's small CPU tensors."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips from inside without one")


@pytest.fixture(autouse=True)
def one_torch_thread():
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
