"""Lightweight structured metrics (counters, timers) emitted as JSON lines.

The aux-subsystem role of the reference's criterion bench output + runtime
gas printing (SURVEY §5 metrics/logging): library code records named
counters/timings into a process-local registry; `dump()` emits one JSON
line per metric (the same line-oriented contract bench.py's driver parses).
Zero-dependency and off the hot path — device-side timing still belongs to
bench.py's host-copy methodology.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import defaultdict
from contextlib import contextmanager

_lock = threading.Lock()
_counters: dict = defaultdict(int)
_timings: dict = defaultdict(list)


def count(name: str, delta: int = 1):
    with _lock:
        _counters[name] += delta


@contextmanager
def timer(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        with _lock:
            _timings[name].append(time.perf_counter() - t0)


def snapshot() -> dict:
    with _lock:
        out = {"counters": dict(_counters)}
        out["timings"] = {
            k: {
                "n": len(v),
                "total_s": round(sum(v), 6),
                "max_s": round(max(v), 6),
            }
            for k, v in _timings.items()
        }
        return out


def dump(stream=None):
    stream = stream or sys.stderr
    snap = snapshot()
    for name, value in snap["counters"].items():
        print(json.dumps({"metric": name, "count": value}), file=stream)
    for name, agg in snap["timings"].items():
        print(json.dumps({"metric": name, **agg}), file=stream)
    stream.flush()


def reset():
    with _lock:
        _counters.clear()
        _timings.clear()
