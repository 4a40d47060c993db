"""Host milliseconds of the verify call (ended by a synchronize) per batch,
over the window's batches that ran without the profiler.  Also reads
``verify.ms_per_batch.stream``, the same in the open-loop cells."""

from benchmark.harness import phases


def read(run):
    return phases.mean_ms(run, "pack", "verify")
