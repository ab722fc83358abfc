"""Run one cell of the PyTorch/CUDA port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

Loads and warms up, measures ``--seconds``, checks the window's outputs
against the plain reference, and prints one JSON line last on standard
output (the numbers compared also go last on standard error). Exits
non-zero without a result when the cell's CUDA cards are missing, when the
program cannot be imported, or when JAX or the JAX package was loaded.
"""
import os
import sys
import time

T0 = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from harness import bench  # noqa: E402

if __name__ == "__main__":
    sys.exit(bench.main(sys.argv[1:], T0))
