"""Times the two ways snark_verifier_tpu_torch.ops.field._columns forms
the schoolbook column sums of its CPU plain Montgomery product (sliding
windows below COLUMN_LOOP_ROWS rows, 16 shifted multiply-adds from there) on
one CPU thread, from 1 to 32768 rows, and checks that they agree.  The
crossover sets COLUMN_LOOP_ROWS.

    python tools/time_plain_columns.py
"""

import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from snark_verifier_tpu_torch.ops import field as F  # noqa: E402
from snark_verifier_tpu_torch.ops.field import NLIMB  # noqa: E402

PATHS = {"windows": 1 << 62, "loop": 0}  # COLUMN_LOOP_ROWS that selects each path


def columns(path, a, b, ncols):
    F.COLUMN_LOOP_ROWS = PATHS[path]
    return F._columns(a, b, ncols)


def best_us(path, a, b, ncols, reps):
    columns(path, a, b, ncols)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            columns(path, a, b, ncols)
        best = min(best, (time.perf_counter() - t0) / reps * 1e6)
    return best


def main():
    torch.set_num_threads(1)
    gen = torch.Generator().manual_seed(0)
    print("rows  ncols  windows_us  loop_us")
    for rows in (1, 4, 16, 64, 256, 1024, 4096, 32768):
        for ncols in (NLIMB, 2 * NLIMB):
            a, b = (torch.randint(0, 1 << 16, (rows, NLIMB), generator=gen) for _ in range(2))
            assert torch.equal(columns("windows", a, b, ncols), columns("loop", a, b, ncols))
            reps = max(3, 20000 // rows)
            print(rows, ncols, *(round(best_us(path, a, b, ncols, reps), 1) for path in PATHS))


if __name__ == "__main__":
    main()
