"""Tracing of a run with ``--trace 1``: torch.profiler over
``trace_batches`` batches that follow the window's close, the harness's
named ranges around the program's layers, and whatever a per-layer metric
asks to record while the profiler runs (its module's ``install(recorder)``:
a range around a function of the program, or the arguments of its calls,
by wrapping module attributes from outside).
"""

from __future__ import annotations

import contextlib
import functools
import time

import numpy as np

# the harness's host ranges, innermost first: an idle gap of the card is
# named after the innermost range the host was in (a metric's ranges come
# before these)
RANGES = ("pack", "verify", "decide", "batch")
TOP = 10


class Recorder:
    """What metrics install while the profiler runs: wrappers around the
    program's module attributes, each undone when the profiler stops."""

    def __init__(self, torch_mod):
        self.torch = torch_mod
        self.data = {}  # a metric's records, under its own key
        self.ranges = []  # range names the metrics added, innermost first
        self.restores = []

    def wrap(self, module, name: str, before=None, after=None) -> None:
        """Call ``before(*args)`` and ``after(result, *args)`` around
        ``module.name``; a counter attribute of the original (``launches``)
        carries over both ways."""
        orig = getattr(module, name)

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            if before is not None:
                before(*args, **kwargs)
            out = orig(*args, **kwargs)
            if after is not None:
                after(out, *args, **kwargs)
            return out

        setattr(module, name, wrapper)

        def restore():
            if "launches" in wrapper.__dict__:
                orig.launches = wrapper.launches
            setattr(module, name, orig)

        self.restores.append(restore)

    def range(self, module, name: str, range_name: str) -> None:
        """A profiler range named ``range_name`` around ``module.name``."""
        orig = getattr(module, name)
        record_function = self.torch.profiler.record_function

        @functools.wraps(orig)
        def wrapper(*args, **kwargs):
            with record_function(range_name):
                return orig(*args, **kwargs)

        setattr(module, name, wrapper)
        self.restores.append(lambda: setattr(module, name, orig))
        self.ranges.append(range_name)

    def undo(self) -> None:
        for restore in reversed(self.restores):
            restore()
        self.restores = []


class Tracer:
    """Off unless ``enabled``: then the profiler runs over the ``batches``
    batches of the traced slice, with the recorders of ``metrics`` (the
    cell's per-layer metric modules) installed."""

    def __init__(self, enabled: bool, batches: int, torch_mod, device, metrics=()):
        self.enabled, self.batches = enabled, batches
        self.torch, self.device = torch_mod, device
        self.metrics = metrics
        self.active = False
        self.prof = None
        self.recorder = Recorder(torch_mod)

    def span(self, name):
        if not self.active:
            return contextlib.nullcontext()
        return self.torch.profiler.record_function(name)

    def start(self) -> None:
        """Start the profiler (once) and the metrics' recorders."""
        if not self.enabled or self.prof is not None:
            return
        for metric in self.metrics:
            if hasattr(metric, "install"):
                metric.install(self.recorder)
        activities = [self.torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(self.torch.profiler.ProfilerActivity.CUDA)
        self.prof = self.torch.profiler.profile(activities=activities)
        self.prof.__enter__()
        self.active = True

    def stop(self) -> None:
        if not self.active:
            return
        if self.device.type == "cuda":
            self.torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.active = False
        self.recorder.undo()

    def summary(self) -> dict | None:
        """What the profiler saw over the traced batches, or None when it
        recorded nothing: device busy seconds (the union of device
        operations), the traced window's length, device time by kernel and
        by operation, the card's idle gaps by the host range they fell in,
        host aten ops, and host seconds under each range."""
        if self.prof is None:
            return None
        t0 = time.perf_counter()
        events = list(self.prof.profiler.kineto_results.events())
        cpu, cuda = self.torch.autograd.DeviceType.CPU, self.torch.autograd.DeviceType.CUDA
        names = (*self.recorder.ranges, *RANGES)
        ranges = {name: [] for name in names}
        device = []
        aten = 0
        for e in events:
            name = e.name()
            start = e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1e3)
            dur = e.duration_ns()
            kind = e.device_type()
            if kind == cpu:
                if name in ranges:
                    ranges[name].append((start, start + dur))
                elif name.startswith("aten::"):
                    aten += 1
            elif kind == cuda and name not in ranges and dur > 0:
                device.append((start, start + dur, name))
        if not ranges["batch"]:
            return None
        lo = min(s for s, _ in ranges["batch"])
        hi = max(e for _, e in ranges["batch"])
        out = {
            "window_s": (hi - lo) * 1e-9,
            "batches": len(ranges["batch"]),
            "aten_ops": aten,
            "range_s": {name: sum(e - s for s, e in spans) * 1e-9 for name, spans in ranges.items()},
            "records": self.recorder.data,
            "busy_s": 0.0,
            "device_s": {},
            "device_ops": [],
            "idle_gaps": [],
        }
        if device:
            starts = np.array([max(s, lo) for s, _, _ in device], dtype=np.int64)
            ends = np.array([min(e, hi) for _, e, _ in device], dtype=np.int64)
            keep = ends > starts
            starts, ends = starts[keep], ends[keep]
            order = np.argsort(starts, kind="stable")
            starts, ends = starts[order], np.maximum.accumulate(ends[order])
            new = np.ones(len(starts), dtype=bool)
            new[1:] = starts[1:] > ends[:-1]
            run_starts = starts[new]
            run_ends = np.append(ends[np.flatnonzero(new)[1:] - 1], ends[-1])
            out["busy_s"] = float((run_ends - run_starts).sum()) * 1e-9
            gap_lo = np.concatenate([[lo], run_ends])
            gap_hi = np.concatenate([run_starts, [hi]])
            gaps = gap_hi > gap_lo
            out["idle_gaps"] = _label_gaps(gap_lo[gaps], gap_hi[gaps], ranges, names)
            for s, e, name in device:
                out["device_s"][name] = out["device_s"].get(name, 0.0) + (e - s) * 1e-9
            ranked = sorted(out["device_s"].items(), key=lambda kv: -kv[1])[:TOP]
            out["device_ops"] = [[name[:120], sec] for name, sec in ranked]
        out["read_s"] = time.perf_counter() - t0
        return out


def _label_gaps(gap_lo, gap_hi, ranges, names) -> list:
    """Idle seconds of the card summed by the innermost harness range that
    held the host at each gap's midpoint, largest first."""
    mids = (gap_lo + gap_hi) // 2
    lengths = (gap_hi - gap_lo) * 1e-9
    labels = np.full(len(mids), len(names))  # index into names; len(names): outside them
    for k, name in enumerate(names):
        spans = np.array(sorted(ranges[name]), dtype=np.int64).reshape(-1, 2)
        if not len(spans):
            continue
        i = np.searchsorted(spans[:, 0], mids, side="right") - 1
        inside = (i >= 0) & (spans[np.maximum(i, 0), 1] >= mids) & (labels == len(names))
        labels[inside] = k
    names = [*names, "outside the harness's ranges"]
    totals = {names[k]: float(lengths[labels == k].sum()) for k in np.unique(labels)}
    return [[name, s] for name, s in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]
