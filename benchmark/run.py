#!/usr/bin/env python3
"""One run of one benchmark cell on cuda:0; prints one JSON result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout (see benchmark/README.md).
"""

import os
import sys
import time

T0 = time.perf_counter()  # set-up runs from here to the first timed request

if __name__ == "__main__":
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path[0] = root  # the checkout root: the port and the benchmark package
    from benchmark.harness.main import main

    sys.exit(main(sys.argv[1:], T0))
