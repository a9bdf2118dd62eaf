"""Fixtures of the benchmark's own tests (``python -m pytest benchmark/tests``
from the repo root). Tests marked ``cuda`` decide on the card inside the
``cuda_device`` fixture and skip without one."""
import pytest


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
