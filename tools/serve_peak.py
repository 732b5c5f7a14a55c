#!/usr/bin/env python3
"""One benchmark run of the checkout in the working directory, with the
card's peak-memory counter reset once the run's inputs are made: the
result line's ``memory_peak_bytes`` is then the serving peak (warm-up and
window), and the peak of making the inputs is printed on standard error
as ``info inputs_peak_bytes``. Arguments are ``perfbench/run.py``'s.

    python3 tools/serve_peak.py --workload mm-bandit-256 --seed 7 \
        --seconds 30 --trace 0
    cd build/parent && python3 ../../tools/serve_peak.py ...   # another tree
"""
import os
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402
from perfbench import run as bench  # noqa: E402
from perfbench.harness import serve  # noqa: E402

_warm = serve.Served.warm


def warm(self, n):
    torch.cuda.synchronize()
    print(f"info inputs_peak_bytes: {torch.cuda.max_memory_allocated()}",
          file=sys.stderr)
    torch.cuda.reset_peak_memory_stats()
    return _warm(self, n)


serve.Served.warm = warm
sys.exit(bench.main(sys.argv[1:]))
