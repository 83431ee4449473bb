"""95th percentile of the host-clock latency of every decompress call in
the window, from the call to its return, in ms."""

import numpy as np


def read(run):
    lat = [c.t1 - c.t0 for c in run.calls if c.op == "decompress"]
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
