"""The control runs that set the upper reading of each compared number.

    python3 rtbench/control.py --workload <cell> --seeds 11,12,13

For each seed it makes the cell's inputs as a run does, and its driver's
``Cell.control()`` puts the plain reference computed in bfloat16 (the
precision below the configuration's float32) in the program's place, and
on a training cell also the reference with a fault planted. Each reading
is judged against the cell's limits as a run's numbers are
(``core.judge``); a control has to come out not correct. One JSON line
per seed and reading. The benchmark's own runs never run this.
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rtbench import core  # noqa: E402


def readings(workload: str, seed: int, device) -> dict:
    """{reading: (checks, failed)} of the cell's control for ``seed``."""
    _, _, config, traffic, _, _ = core.find_cell(workload)
    cell = core.driver(traffic).Cell(config, traffic, seed, device)
    limit = core.limits(workload)
    return {name: core.judge(numbers, limit)
            for name, numbers in cell.control().items()}


def main(argv):
    import argparse

    import torch
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)
    cell = core.find_cell(args.workload)[0]
    core.require_cards(int(cell["chips"]))
    device = torch.device("cuda:0")
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        for name, (checks, failed) in readings(args.workload, seed,
                                               device).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "reading": name, "correct": failed == 0,
                              "checks": checks,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
