"""An open loop: single proofs arrive at ``rate_per_s`` (Poisson), and each
iteration takes every proof due by then, up to ``max_batch``, as one batch.
A proof's latency runs from its due time to its verdict on the host.

Every seed gets the same inter-arrival gaps in another order: the gaps are
the quantiles (i + 1/2) / n of the exponential distribution, shuffled by
the seed.  Mix parameters: ``rate_per_s``, ``max_batch``, ``bad_share``."""

from __future__ import annotations

import time

import numpy as np

from benchmark.harness.rows import RowStream, rng


def arrivals(rate: float, count: int, gen: np.random.Generator) -> np.ndarray:
    """Due times (seconds from the window's start) of ``count`` proofs."""
    q = (np.arange(count) + 0.5) / count
    return np.cumsum(gen.permutation(-np.log1p(-q) / rate))


def warm_rows(mix: dict, session, seed: int):
    """The set-up's batch: the largest shape the stream can take."""
    return RowStream(rng(seed, 1), session.good, session.bad, mix["bad_share"]).take(mix["max_batch"])


def drive(window, mix: dict, session, seed: int) -> None:
    rate, cap = mix["rate_per_s"], mix["max_batch"]
    count = int(rate * (2 * window.seconds + 30))
    due = arrivals(rate, count, rng(seed, 3))
    ids = RowStream(rng(seed, 2), session.good, session.bad, mix["bad_share"]).take(count)
    window.start()
    i = 0
    taken_at = 0.0
    while not window.closed and i < count:
        wait = due[i] - window.now()
        if wait > 0:
            time.sleep(wait)
        taken_at = window.now()
        due_now = int(np.searchsorted(due, taken_at, side="right"))
        j = max(i + 1, min(due_now, i + cap))
        window.backlog.append(max(0, due_now - j))
        window.run(ids[i:j], due=due[i:j])
        i = j
    # due by the last take, and left behind by it: the backlog at the close
    window.unserved_due = due[i : max(i, int(np.searchsorted(due, taken_at, side="right")))]
    while not window.done and i < count:  # the traced slice: the stream goes on
        j = max(i + 1, min(int(np.searchsorted(due, window.now(), side="right")), i + cap))
        window.run(ids[i:j], due=due[i:j])
        i = j
