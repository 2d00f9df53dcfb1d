"""Run one cell of the benchmark once and print its result line.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cells, metrics and bounds are in ``BENCHMARK.json`` at the root of
the checkout; ``rtbench/core.py`` says how a run goes. The run needs the
CUDA devices its cell asks for and exits without a result otherwise.
"""

import sys
import time

T_START = time.perf_counter()

from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from rtbench.core import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
