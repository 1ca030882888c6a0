"""The benchmark's own tests run from the repository's root:
``python -m pytest fsibench/tests -q``. Tests marked ``cuda`` need the card
and skip without one (the check is made in a fixture, not at import)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
