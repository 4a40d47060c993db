"""The measured window: whole batches of a session against the host clock.

A window starts at its first batch and closes at the end of the first batch
that ends at or after ``seconds``; every rate is the work it completed over
all of that time, and a tail is taken over every proof it holds.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Batch:
    """One batch of the window; times in seconds from the window's start."""

    size: int
    start: float
    phases: dict  # phase name -> its end time
    end: float
    due: np.ndarray | None = None  # open loop: each proof's due time


@dataclass
class Window:
    """Drives ``session.batch`` and records each batch.  In a traced run,
    ``tracer.batches`` more batches follow the window's close under the
    profiler (the traced slice), so that the profiler's start, overhead
    and stop stay out of the window."""

    session: object
    seconds: float
    tracer: object
    batches: list = field(default_factory=list)
    traced: list = field(default_factory=list)  # the traced slice, after the close
    unserved_due: np.ndarray = field(default_factory=lambda: np.zeros(0))  # due before the close, never served
    backlog: list = field(default_factory=list)  # open loop: proofs due but left behind at each take
    t0: float | None = None

    def start(self) -> None:
        self.t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self.t0

    @property
    def closed(self) -> bool:
        return bool(self.batches) and self.batches[-1].end >= self.seconds

    @property
    def done(self) -> bool:
        return self.closed and len(self.traced) >= (self.tracer.batches if self.tracer.enabled else 0)

    @property
    def length_s(self) -> float:
        return self.batches[-1].end

    def run(self, rows: np.ndarray, due: np.ndarray | None = None) -> Batch:
        """One batch of the input rows ``rows`` (ids into the session's
        inputs): in the window until it closes, then in the traced slice."""
        traced = self.closed
        if traced:
            self.tracer.start()
        start = self.now()
        with self.tracer.span("batch"):
            marks = self.session.batch(rows, self.tracer.span)
        end = self.now()
        batch = Batch(len(rows), start, {k: v - self.t0 for k, v in marks.items()}, end, due)
        (self.traced if traced else self.batches).append(batch)
        return batch

    def proofs(self) -> int:
        return sum(b.size for b in self.batches)

    def latencies_s(self) -> np.ndarray:
        """Each proof's time from its due time to its verdict, the proofs
        left unserved at the close counted up to the close."""
        served = [b.end - b.due for b in self.batches if b.due is not None]
        late = [self.length_s - self.unserved_due] if len(self.unserved_due) else []
        return np.concatenate(served + late) if served or late else np.zeros(0)
