"""The 95th percentile, over every proof of the window, of the time from the
proof's due time to its verdict on the host (host clock); proofs left
unserved at the close count up to the close."""

import numpy as np


def read(run):
    lat = run.window.latencies_s()
    return float(np.percentile(lat, 95) * 1e3) if len(lat) else None
