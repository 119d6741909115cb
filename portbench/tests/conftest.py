"""The benchmark's own tests. Those that need a CUDA card carry the
``card`` marker and take the ``card`` fixture, which skips them where
there is none; whether there is a card is decided inside the fixture,
never while a module is imported."""

import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: this test runs on the chip")
    return "cuda"


@pytest.fixture(autouse=True)
def _tmpdir_env(tmp_path, monkeypatch):
    # A run's scratch directory goes under TMPDIR.
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    import tempfile

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    yield
    for key in ("LO_TPU_STORE_ROOT", "LO_TPU_IMAGE_ROOT", "LO_TPU_PERSIST"):
        os.environ.pop(key, None)
