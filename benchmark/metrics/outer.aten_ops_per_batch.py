"""Host aten operations the profiler recorded per traced batch of the outer
snark: the host dispatch of the loader, the quotient's expression and the
plain-torch field and curve ops."""


def read(run):
    t = run.trace
    return t["aten_ops"] / t["batches"] if t and t["batches"] else None
