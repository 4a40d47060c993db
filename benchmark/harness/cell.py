"""One run of one cell: set-up, the measured window, the check against the
reference, the metrics, and the result line."""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from dataclasses import dataclass

from benchmark.harness import guard, registry
from benchmark.harness.trace import Tracer
from benchmark.harness.window import Window


@dataclass
class Run:
    """What a metric's reader reads."""

    setup_s: float
    window: Window
    trace: dict | None


def _no_span(name):
    return contextlib.nullcontext()


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float, metrics: list[dict],
             program: str = "Session", log=None) -> dict:
    """Set up, measure, check; returns the result line as a dict, its
    ``checks`` last.  ``program`` names the session class of the cell's
    system: the program (``Session``) or its control (``Control``)."""
    import torch

    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    cuda = device.type == "cuda"
    build_s = 0.0
    if cuda and program == "Session":
        from snark_verifier_tpu_torch import _build

        build_s = _build.build()[1]
    config, mix = cell["config_data"], cell["mix"]
    system = registry.load_module("systems", config["system"])
    traffic = registry.load_module("traffic", mix["kind"])
    session = getattr(system, program)(config, mix, seed, device, torch)
    t_warm = time.perf_counter()
    session.batch(traffic.warm_rows(mix, session, seed), _no_span)
    session.forget()
    if cuda:
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_warm
    setup_s = time.perf_counter() - t_start
    peak_setup = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    readers = {m["name"]: registry.reader(m["name"]) for m in metrics}
    tracer = Tracer(trace, cell.get("trace_batches", 1), torch, device, list(readers.values()) if trace else ())
    window = Window(session, seconds, tracer)
    traffic.drive(window, mix, session, seed)
    tracer.stop()
    peak_window = torch.cuda.max_memory_allocated(device) if cuda else 0
    session.probe(traffic.warm_rows(mix, session, seed))
    summary = tracer.summary() if trace else None
    log(f"set-up {setup_s:.3f} s (kernel build {build_s:.3f} s, warm-up batch {warm_s:.3f} s); window "
        f"{window.length_s:.3f} s, {len(window.batches)} batches, {window.proofs()} proofs"
        + (f"; profiler read in {summary['read_s']:.1f} s" if summary else ""))
    log("batch walls (ms): " + " ".join(f"{1e3 * (b.end - b.start):.0f}" for b in window.batches))

    session.release()
    t_check = time.perf_counter()
    checks = session.check()
    log(f"reference check {time.perf_counter() - t_check:.3f} s")
    run = Run(setup_s, window, summary)
    values = {}
    for m in metrics:
        value = readers[m["name"]].read(run)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else device.type, "kind": torch.cuda.get_device_name(device) if cuda else device.type,
           "count": cell["chips"], "memory_peak_bytes": max(peak_setup, peak_window)}
    result = {"correct": all(v <= lim for v, lim in checks.values()),
              "attempted": window.proofs() + len(window.unserved_due), "failed": len(window.unserved_due),
              "metrics": values, "device": dev}
    if trace:
        dev["busy_s"] = summary["busy_s"] if summary else 0.0
        dev["window_s"] = summary["window_s"] if summary else 0.0
        if summary:
            result["breakdown"] = {"device_ops": summary["device_ops"], "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return result


def parse(argv):
    ap = argparse.ArgumentParser(description="One run of one benchmark cell of snark_verifier_tpu_torch.")
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the window: whole batches until this is reached")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0, help="1: per-layer metrics from a profiled run")
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    spec = registry.benchmark_spec()
    cell = registry.cell(spec, args.workload)
    e2e, layer = registry.cell_metrics(spec, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); found {found}: nothing measured", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t_start,
                      layer if args.trace else e2e)
    found = guard.forbidden_modules()
    if found:
        print(f"the run loaded modules it must not: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
