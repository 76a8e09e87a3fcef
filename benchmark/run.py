"""The benchmark of plutracer_tpu_torch on NVIDIA cards: one run of one cell.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout (the folder that holds BENCHMARK.json).
plubench/main.py says what a run does and prints.
"""

import time

T_START = time.perf_counter()  # set-up runs from here: imports count

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]  # the harness, and the program beside it

from plubench.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
