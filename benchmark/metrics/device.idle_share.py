"""The share of a batch's wall time in which no operation ran on the card:
the device's busy time per batch of the traced slice (the union of its
operations) over the mean wall time of the window's batches.  Reads every
``device.idle_share.<part>`` metric (one part for each end-to-end metric
that its cells report)."""

from benchmark.harness import phases


def read(run):
    return phases.idle_share(run)
