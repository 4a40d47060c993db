"""Device milliseconds of K7's kernels (``miller_loop`` and ``final_exp``)
per traced batch: the per-proof decide of the fresh and the decoded
accumulator."""

from benchmark.harness import phases


def read(run):
    t = run.trace
    if not t or not t["batches"]:
        return None
    device_s = phases.kernel_s(t, "miller_loop") + phases.kernel_s(t, "final_exp")
    return 1e3 * device_s / t["batches"] if device_s else None
