"""CPU tests of the benchmark: tiny configurations through the real harness.

Run from the repository root: ``python -m pytest ffbench/tests -q``. Tests
marked ``gpu`` run a cell on a CUDA card and skip without one:
``python -m pytest ffbench/tests -q -m gpu``.
"""

import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

torch.set_num_threads(1)


@pytest.fixture
def tiny_bench(tmp_path):
    from ffbench.tests import tiny

    return tiny.make_bench(tmp_path)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
