"""The benchmark's own tests: the harness on the CPU at tiny sizes, and
(marked cuda) the control at the cells' sizes on the card.

    python -m pytest -o addopts="" benchmark/tests -q

from the root of the repository. Tests marked cuda need a CUDA card and
skip without one (decided in the ``cuda_device`` fixture)."""

import pathlib
import sys

import pytest
import torch

BENCH = pathlib.Path(__file__).resolve().parent.parent
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")
