"""The benchmark's own tests: ``python -m pytest -q portbench/tests`` from
the repository's root.  Tests that need a CUDA card carry the ``card``
marker and skip elsewhere (the ``card`` fixture decides, at run time)."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
for p in (ROOT, os.path.join(ROOT, "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "card: needs a CUDA card; skips elsewhere")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: runs on the chip")
    return torch.device("cuda", 0)


@pytest.fixture(scope="session")
def root():
    return ROOT
