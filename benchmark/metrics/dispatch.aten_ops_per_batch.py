"""Host aten operations the profiler recorded per traced batch: the host
dispatch of the loader and the plain-torch field, Keccak and curve ops."""


def read(run):
    t = run.trace
    return t["aten_ops"] / t["batches"] if t and t["batches"] else None
