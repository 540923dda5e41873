"""The benchmark's own tests: CPU tests of its arithmetic, files and
imports, the planted faults at a small size on the CPU, and card tests
(marked ``cuda``) of the control at the cells' own sizes.

    python -m pytest benchmark/tests -q -p no:cacheprovider
    python -m pytest benchmark/tests -q -p no:cacheprovider -m cuda   # on a GPU
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


@pytest.fixture
def gpu():
    """Skips a test on a machine without a CUDA device."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")
