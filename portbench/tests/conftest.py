"""Settings of the benchmark's own tests (``python -m pytest
portbench/tests``): the ``cuda`` marker, as the repository's tests
register it."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU; skips where torch.cuda.is_available() "
        "is false",
    )
