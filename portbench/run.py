#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with a CUDA card.  The last line
of standard output is the result as one JSON object; the numbers compared
with the reference are the last lines of standard error.  ``--trace 1``
reports the cell's per-layer metrics from a profiler trace of part of the
window, ``--trace 0`` its end-to-end metrics.  Without a card, or with
fewer than the cell asks for, it prints no result and exits with 3.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # Compile caches at fixed paths inside the checkout; the port's kernel
    # library is built into its own package directory.
    cache = BENCH / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(cache / "inductor")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    # One process, few threads: the host's dispatch is on the timed path.
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ["MKL_NUM_THREADS"] = "1"
    sys.path.insert(0, str(BENCH.parent))
    from portbench import harness

    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
