#!/usr/bin/env python3
"""The readings that the comparison's limits are set from.

    python3 portbench/checks.py --workload <cell> --seeds 1 2 3 ...

For each seed, on the card and at the cell's own size: each compared
number as the program reads it against the plain reference, and as the
control (the reference in the next lower precision) reads it.  One JSON
line per seed on standard output.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(BENCH.parent))
    from portbench import harness

    cell = harness.find_cell(args.workload)
    device = harness.card(cell.chips)
    for seed in args.seeds:
        out = cell.generator.readings(cell, seed, device)
        print(json.dumps({"workload": cell.name, "seed": seed, "readings": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
