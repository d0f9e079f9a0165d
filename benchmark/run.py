"""Entry point of the benchmark: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's record on earlier lines and, last on stdout, the result as
one JSON object; each compared number beside its limit last on stderr.
Exits non-zero, printing no result, without the CUDA cards the cell asks
for, or where JAX or the JAX package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The checkout's root, not this directory, leads the import path: the
# benchmark's module names must not shadow the standard library's.
sys.path[0] = ROOT
# Kernel caches stay inside the checkout, at fixed paths.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "benchmark", "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "benchmark", "triton"))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t0=T0))
