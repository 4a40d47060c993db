"""Process start to the first timed batch: imports, the kernel build where
the checkout has none, inputs, the program's set-up and one warm-up batch."""


def read(run):
    return run.setup_s
