#!/usr/bin/env python3
"""The readings of a cell's control: the reference in the program's place
with one of the configuration's guarantees broken (each system's
``Control``), through the cell's own traffic and check, on each seed.  The
limits of ``correct`` sit below the least of these readings.

    python3 benchmark/control.py --workload keccak_b1820 --seconds 10 --seeds 1,2,3
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import registry  # noqa: E402
from benchmark.harness.cell import run_cell  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    args = ap.parse_args(argv)
    import torch

    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    cell = registry.cell(registry.benchmark_spec(), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run_cell(cell, seed, args.seconds, False, device, time.perf_counter(), [], program="Control")
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"], "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
