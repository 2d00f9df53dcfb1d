"""The benchmark's command on the test bench beside this file, whose
cells, traffic, driver, limits and metric sit here in the layout of
``rtbench/`` and are in no ``BENCHMARK.json``:

    RANKS_DEVICE=cpu python3 rtbench/tests/ranks/entry.py \
        --workload ranks-two --seed 1 --seconds 1 --trace 0

With ``RANKS_DEVICE=cpu`` (the default) the cells run on the CPU and no
card is looked for; with ``cuda`` they need their cards as a run does.
A cell on more than one card runs its ranks through ``rtbench/ranks.py``,
each rank being this script again.
"""

import os
import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[2]))

from rtbench import core  # noqa: E402

if __name__ == "__main__":
    core.BENCHMARK = HERE / "bench.json"
    core.HERE = HERE
    on_cpu = os.environ.get("RANKS_DEVICE", "cpu") == "cpu"
    if on_cpu:
        core.require_cards = lambda n: None
    sys.exit(core.main(sys.argv[1:], T_START,
                       device="cpu" if on_cpu else None))
