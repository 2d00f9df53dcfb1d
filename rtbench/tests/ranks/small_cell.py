"""The benchmark's command on a cell of ``BENCHMARK.json`` at the size a
test on the CPU can hold (the ``SMALL`` of its scene kind and of its
driver), with a cell on more than one card run as CPU ranks through the
real launcher:

    python3 rtbench/tests/ranks/small_cell.py \
        --workload terrain190k-render-4chip --seed 1 --seconds 1 --trace 0

No card is looked for. ``MESH_FAULT`` plants a fault in the ranks'
progressive rendering over the mesh: ``shift`` moves rank 1's run one
share tile on, ``drop`` leaves rank 3's run unrendered.
"""

import functools
import os
import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[3]))

from rtbench import core  # noqa: E402
from rtbench.tests.common import small  # noqa: E402


def plant(fault: str, rank: int):
    from ray_tracer_tpu_torch.parallel import progressive as p
    if fault == "shift" and rank == 1:
        true = p._rank_ids

        def shifted(ids, start, stop, tile):
            return true(ids, start + tile, stop + tile, tile)
        p._rank_ids = shifted
    elif fault == "drop" and rank == 3:
        p._render_run = lambda scene, basis, params, ids, *a: a[-1]


if __name__ == "__main__":
    argv = sys.argv[1:]
    core.require_cards = lambda n: None
    core.run_cell = functools.partial(
        core.run_cell, overrides=small(core.parse(argv).workload))
    if "RANK" in os.environ and os.environ.get("MESH_FAULT"):
        plant(os.environ["MESH_FAULT"], int(os.environ["RANK"]))
    sys.exit(core.main(argv, T_START, device="cpu"))
