"""The benchmark's tests: `python -m pytest benchmark/tests -q` from the root of
a checkout. Tests marked `cuda` run on a card and skip elsewhere; whether a
card is there is decided inside the `cuda_device` fixture, never at import."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for p in (str(ROOT), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skipped where CUDA is absent")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda", 0)
