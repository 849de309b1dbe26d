"""The benchmark's tests: on the CPU at tiny sizes, where the program runs
its plain versions; a test marked `gpu` runs a cell at its own size and
skips without a card."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    import mdbench_tiny

    return mdbench_tiny.make_root(tmp_path_factory.mktemp("checkout"))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
