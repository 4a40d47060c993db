"""Host milliseconds of the outer snark's verify call with its per-proof
decide of both accumulators, from the pack's end to the synchronize that
ends it, over the window's batches that ran without the profiler."""

from benchmark.harness import phases


def read(run):
    return phases.mean_ms(run, "pack", "verify")
