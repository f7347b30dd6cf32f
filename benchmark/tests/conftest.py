"""The benchmark's own tests: its manifest and files, the import guard, the
reference against the measured program at tiny sizes on the CPU, the
bfloat16 control and the planted faults failing the comparison. Tests
that need a CUDA card carry the `cuda` marker and skip without one."""
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run the port's CUDA kernels")
    return torch.device("cuda", 0)
