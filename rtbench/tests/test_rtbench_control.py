"""The control, the plain reference in bfloat16 put in the program's
place, fails the cell's limits at a size a test can hold, judged as a
run's numbers are."""

import pytest
import torch

from rtbench import core
from rtbench.tests.common import CELLS, small_cell


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    torch.set_num_threads(2)
    readings = small_cell(cell, 2 ** 31 + 5).control()
    checks, failed = core.judge(readings["control"], core.limits(cell))
    assert failed >= 1, checks
