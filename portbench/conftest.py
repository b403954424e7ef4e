"""pytest settings of the benchmark's own tests (`portbench/tests`).

Tests that need an NVIDIA card carry the `card` marker and take the
`card` fixture, which skips them where torch sees no card. Run them on
the card's machine with

    python3 -m pytest portbench/tests -m card -s
"""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the control and the faults are read at "
                    "the cell's own size on the card")
    return torch.device("cuda")
