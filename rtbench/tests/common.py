"""Helpers of the benchmark's tests: the cells of ``BENCHMARK.json`` and
runs of a cell on the CPU at a size a test can hold (the ``SMALL`` of its
scene kind and of its driver)."""

import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = tuple(w["name"] for w in BENCH["workloads"])


def cells_of(driver):
    """The cells whose traffic mix runs on ``driver``."""
    from rtbench import core
    return tuple(c for c in CELLS
                 if core.find_cell(c)[3]["driver"] == driver)


def small(workload):
    """The overrides that shrink ``workload`` to a test's size."""
    from rtbench import core, scenes
    _, _, config, traffic, _, _ = core.find_cell(workload)
    return {"scene": scenes.kind(config["scene"]["kind"]).SMALL,
            "traffic": core.driver(traffic).SMALL}


def small_cell(workload, seed, device="cpu"):
    """A driver's Cell of ``workload`` at a test's size, not set up."""
    import torch
    from rtbench import core
    _, _, config, traffic, _, _ = core.find_cell(workload)
    o = small(workload)
    config = dict(config, scene=dict(config["scene"], **o["scene"]))
    traffic = dict(traffic, **o["traffic"])
    return core.driver(traffic).Cell(config, traffic, seed,
                                     torch.device(device))


def run_small(workload, seed=2 ** 31 + 11, trace=False, seconds=0.3):
    """One run of ``workload`` on the CPU at a test's size → the result
    line as a dict."""
    import torch
    from rtbench import core
    torch.set_num_threads(2)
    return core.run_cell(workload, seed, seconds, trace, time.perf_counter(),
                         device="cpu", overrides=small(workload))
