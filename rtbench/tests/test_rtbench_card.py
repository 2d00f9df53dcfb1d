"""On the card: one short run of each cell through the command line,
correct, with the card named and the power limit read."""

import json
import subprocess
import sys

import pytest

from rtbench.tests.common import CELLS, ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_a_short_run_on_the_card(cell, card):
    out = subprocess.run(
        [sys.executable, "rtbench/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    assert r["correct"] is True
    assert r["device"]["platform"] == "gpu" and r["device"]["count"] == 1
    assert "W" in r["device"]["power"]
