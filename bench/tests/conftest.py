"""The benchmark's own tests: ``python -m pytest bench/tests`` from the
root of the repository (they import ``fbench`` and the port, never the
JAX package). Tests marked ``cuda`` need the card and skip without one."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))
sys.path.insert(1, str(BENCH.parent / "src"))


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
