"""Host milliseconds per batch from the verify's end to the verdicts on the
host: the fold scalars' draw, the batch decide (fold MSMs, pairing) and the
copy of the verdicts, over the window's batches that ran without the
profiler."""

from benchmark.harness import phases


def read(run):
    return phases.mean_ms(run, "verify", "decide")
