"""Run one cell of the benchmark on one NVIDIA H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the run's comparisons on standard error
and its result as one JSON object, the last line of standard output.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# compiled bytecode of every module the run imports is kept in the checkout,
# so that only a checkout's first run compiles it
sys.pycache_prefix = str(ROOT / "build" / "pycache")
sys.dont_write_bytecode = False
# the checkout's root, in place of this script's folder (whose module names
# would shadow the standard library's)
sys.path[0] = str(ROOT)

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
