"""Tests of the benchmark itself, run apart from the repository's suite:

    python -m pytest -q portbench/tests

Tests marked `cuda` need a card and skip without one; on the card the
same command runs them all."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def device(request):
    """The device a test runs on: its `device` parameter, "cpu" unless
    given; a "cuda" test skips where there is no card."""
    import torch

    name = getattr(request, "param", "cpu")
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return name


#: small sizes of each configuration, for runs on the CPU and card tests
SMALL = {"cusz-nyx": {"shape": [24, 40, 48]},
         "cusz-hacc": {"shape": [200003]}}
CELLS = ("cusz-nyx.compress", "cusz-nyx.decompress",
         "cusz-hacc.compress", "cusz-hacc.decompress")
DEVICES = ("cpu", pytest.param("cuda", marks=pytest.mark.cuda))
