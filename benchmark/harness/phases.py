"""Arithmetic the metric readers share."""

from __future__ import annotations


def mean_ms(run, begin: str, end: str) -> float | None:
    """Mean host milliseconds from phase ``begin``'s end to phase ``end``'s
    end over the window's batches (none of which ran under the profiler)."""
    spans = [b.phases[end] - b.phases[begin] for b in run.window.batches]
    return 1e3 * sum(spans) / len(spans) if spans else None


def idle_share(run) -> float | None:
    """The share of a batch's wall time in which no operation ran on the
    card: the device's busy time per batch of the traced slice over the mean
    wall time of the window's batches (the profiler slows the host, not the
    card)."""
    t = run.trace
    if not t or t["busy_s"] <= 0:
        return None
    walls = [b.end - b.start for b in run.window.batches]
    return 100.0 * (1.0 - t["busy_s"] / t["batches"] / (sum(walls) / len(walls)))


def kernel_s(trace: dict, kernel: str) -> float:
    """Device seconds of the hand-written kernel ``kernel`` (its CUDA symbol
    is ``<kernel>_kernel``) in the traced slice."""
    symbol = f"{kernel}_kernel"
    return sum(s for name, s in trace["device_s"].items() if symbol in name)
