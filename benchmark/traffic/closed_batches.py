"""A closed loop of one caller: the next batch of ``batch`` rows goes in
once the last one has its verdicts.  Mix parameters: ``batch`` (rows per
batch) and ``bad_share`` (the share of rows the succinct verify or the
decide must reject)."""

from __future__ import annotations

from benchmark.harness.rows import RowStream, rng


def warm_rows(mix: dict, session, seed: int):
    """The rows of the set-up's batch: the cell's one batch shape."""
    return RowStream(rng(seed, 1), session.good, session.bad, mix["bad_share"]).take(mix["batch"])


def drive(window, mix: dict, session, seed: int) -> None:
    stream = RowStream(rng(seed, 2), session.good, session.bad, mix["bad_share"])
    window.start()
    while not window.done:
        window.run(stream.take(mix["batch"]))
