"""The control of a cell's comparison, and the faults it must catch, read at
the cell's own size on the card:

    python3 h100_bench/control.py --workload <name> --seeds 1 2 3 [--size D H W]

For each seed it makes the cell's inputs as a run does and puts the plain
reference, computed in the next precision below the cell's (TF32 for a
float32 cell, float8 e4m3 for a bfloat16 one), in the program's place:
its numbers go through the cell's comparison against the full-precision
reference, and must come out over the cell's limits. For a data-parallel
cell it also plants the faults of a step over ranks in the reference (half
of the batch left out; no exchange between ranks) and reads them the same
way. Each runner (``runners/<runner>.py``) defines its cell's control as
``control(cell, seeds, device, model, lowp, faults)``. The benchmark's own
runs do not run this. Prints one JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from h100_bench import harness  # noqa: E402

LOWER = {"float32": "tf32", "bfloat16": "fp8"}


def read(name: str, seed: int, size=None, device="cuda", faults=()) -> list:
    """The control's numbers of the cell ``name`` on ``seed``, then those of
    each planted fault of ``faults``."""
    cell = harness.Cell(name)
    model = dict(cell.config["model"])
    if size:
        model["inshape"] = list(size)
    return cell.runner().control(cell, harness.Seeds(seed), device, model,
                                 LOWER[cell.traffic["dtype"]], faults)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--size", type=int, nargs=3)
    p.add_argument("--faults", nargs="*", default=[],
                   help="planted faults of a data-parallel step: half_batch no_exchange")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        harness.log("the control runs on the card")
        return 3
    limits = harness.Cell(args.workload).spec["limits"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        for fault, got in zip([None, *args.faults],
                              read(args.workload, seed, args.size, faults=args.faults)):
            over = [k for k in limits if not got[k] <= limits[k]]
            print(json.dumps({"workload": args.workload, "seed": seed, "fault": fault,
                              "numbers": got, "over_limits": over,
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
