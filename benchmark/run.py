"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the CUDA devices the
cell asks for. Without them it exits with code 2 and prints no result.
The last line of standard output is the result's JSON object; the last
lines of standard error are the numbers compared, each beside its limit.
"""

import time

START = time.time()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], START))
