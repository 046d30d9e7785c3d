"""The readings that a cell's limits are set from, in one process on the card.

    python3 -m benchmark.readings --workload <name> --seeds 1,2,3 --control-seeds 4,5,6

The cell's entry (entries/<entry>.py) reads, for each of `--seeds`, the
check's numbers of the port at the cell's own size (the lower readings:
sound runs), and for each of `--control-seeds` those of the control, the
reference in a lower precision in the port's place (the upper readings).
One JSON line per reading goes to stdout.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import cell
from .run import ROOT, caches, cell_spec


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    args = ap.parse_args(argv)
    caches()
    spec = cell_spec(json.loads((ROOT / "BENCHMARK.json").read_text()), args.workload)
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    config, traffic, check = spec["config"], spec["traffic"], spec["check"]
    cell.entry(traffic).readings(config, traffic, check, args.seeds, args.control_seeds,
                                 "cuda", sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
