"""On a card: a run of each cell at the CPU tests' small sizes through the
program's card path (the bake, K1, K2) is correct, and the
control is not.  Skips without a CUDA card; run on the card with
`python -m pytest perfbench/tests/test_perfbench_card.py`."""

from __future__ import annotations

import pytest
import torch

from perfbench.compare import judge, load_limits
from perfbench.control import control_numbers
from perfbench.run import run_cell
from perfbench.tests.test_perfbench_correct import SEED, SIZES

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


@pytest.mark.parametrize("cell", sorted(SIZES))
def test_a_small_run_on_the_card_is_correct_and_the_control_is_not(card, cell):
    line, numbers = run_cell(cell, SEED + 1, 1.5, False, card,
                             {"platform": "gpu"}, overrides=SIZES[cell])
    assert line["correct"], numbers
    ok, checks = judge(control_numbers(cell, SEED + 1, card, overrides=SIZES[cell]),
                       load_limits(cell))
    assert not ok, checks
