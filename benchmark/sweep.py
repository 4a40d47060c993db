#!/usr/bin/env python3
"""The knee of an open-loop cell: its stream at each of several rates, one
window each, in one process (one set-up).  For each rate it prints the
batches, their sizes, the backlog left behind at each take (its mean over
the window's first and last thirds), the completed rate and the p95
latency.  The knee is the highest rate whose backlog does not grow.

    python3 benchmark/sweep.py --workload keccak_poisson --seed <n> --seconds 10 --rates 4000,6000,8000
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

from benchmark.harness import registry  # noqa: E402
from benchmark.harness.trace import Tracer  # noqa: E402
from benchmark.harness.window import Window  # noqa: E402


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True, help="proofs/s, comma-separated")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: nothing measured", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = registry.cell(registry.benchmark_spec(), args.workload)
    config, mix = cell["config_data"], cell["mix"]
    system = registry.load_module("systems", config["system"])
    traffic = registry.load_module("traffic", mix["kind"])
    session = system.Session(config, mix, args.seed, device, torch)
    session.batch(traffic.warm_rows(mix, session, args.seed), lambda name: contextlib.nullcontext())
    session.forget()
    torch.cuda.synchronize()
    print(f"set-up {time.perf_counter() - T_START:.2f} s on {torch.cuda.get_device_name(device)}", file=sys.stderr)
    for rate in (float(r) for r in args.rates.split(",")):
        window = Window(session, args.seconds, Tracer(False, 0, torch, device))
        traffic.drive(window, {**mix, "rate_per_s": rate}, session, args.seed)
        session.forget()
        sizes = np.array([b.size for b in window.batches])
        backlog = np.array(window.backlog, dtype=float)
        third = max(1, len(backlog) // 3)
        lat = window.latencies_s()
        print(json.dumps({
            "rate_per_s": rate, "window_s": window.length_s, "batches": len(sizes), "mean_batch": float(sizes.mean()),
            "max_batch": int(sizes.max()), "at_cap": int((sizes == mix["max_batch"]).sum()),
            "backlog_first_third": float(backlog[:third].mean()), "backlog_last_third": float(backlog[-third:].mean()),
            "unserved_at_close": len(window.unserved_due), "completed_per_s": window.proofs() / window.length_s,
            "p50_ms": float(np.percentile(lat, 50) * 1e3), "p95_ms": float(np.percentile(lat, 95) * 1e3),
            "p99_ms": float(np.percentile(lat, 99) * 1e3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
