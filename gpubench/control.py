"""The readings that bound each cell's limits from above, on the card at
the cell's own size: the control (the reference one precision below the
configuration's, in the program's place, controls.py) against the
reference, and in a training cell the planted fault of half of each batch
left out (the reference on the first half) against the reference.  The
benchmark's runs never run this.

    python -m gpubench.control --workload NAME --seeds S1 S2 S3 ...

Prints one JSON line per seed and reading.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import cells


def readings(cell, seed, device="cuda"):
    """{reading: numbers} of the cell's traffic kind."""
    return cells.kind(cell.kind).readings(cell, seed, device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gpubench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on the card", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    for s in args.seeds:
        for kind, numbers in readings(cell, s).items():
            print(json.dumps({"workload": cell.name, "seed": s,
                              "reading": kind, **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
