"""Fixtures of the benchmark's tests, and the card marker.

Tests that need an NVIDIA card are marked ``card``; the ``cuda_device``
fixture skips them when there is none (decided here, never at import).
Run them on a card with ``python -m pytest benchmark/tests -m card``.
"""

import pytest

from benchmark.tests.helpers import tiny_manifest


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """(manifest, root) of the tiny cells; the index cache is shared by
    the session's runs."""
    root = str(tmp_path_factory.mktemp("bench"))
    return tiny_manifest(root), root


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skipped without one)")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this process")
    return "cuda:0"
