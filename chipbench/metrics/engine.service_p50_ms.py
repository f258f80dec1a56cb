"""Serving engine: the median of the engine's own service time
(``Result.service_s``: the bucket's forward call to its harvest) over the
window's requests, in ms."""
import numpy as np


def read(ctx):
    s = ctx["service_s"]
    return 1e3 * float(np.median(s)) if len(s) else None
