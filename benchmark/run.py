"""Run one cell of the benchmark of raptor_tpu_torch on the CUDA card(s) of
this machine, from the root of a checkout:

    python3 benchmark/run.py --workload distill_train --seed 7 --seconds 30 --trace 0

Prints the result as one JSON line, last on standard output; see core.py.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

import core  # noqa: E402

if __name__ == "__main__":
    core.use_checkout_caches()
    sys.exit(core.main(t_start=T_START))
