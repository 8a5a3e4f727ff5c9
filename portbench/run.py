#!/usr/bin/env python3
"""Run one cell of the port's benchmark once::

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``src/repro_torch``).
Earlier lines of standard output are JSON lines of the run's phases; the
last line is the result. Exits non-zero, printing no result, without the
CUDA devices the cell asks for, or if the run loaded JAX or the JAX
package.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache of the program lives at a fixed path
    # inside the checkout (the port's nvcc builds go to build/repro_torch)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from portbench import harness
    return harness.main(args, t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
