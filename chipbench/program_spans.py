"""The program's own spans (``repro_torch.launch.trace.TRACER``) over the
measured window, for the ``program_span`` readers.

The window runs from the first to the last ``round.*`` span of the
benchmark's.  A reader reads only where the run has a traced slice on a
card, and reads nothing from a program without the tracer.
"""
from __future__ import annotations

import numpy as np


def window_records(ctx):
    """-> (the tracer's records that started in the window, its wall
    seconds), or None."""
    if not ctx.get("profile"):
        return None
    rounds = [(a, b) for name, a, b in ctx["spans"]
              if name.startswith("round.")]
    if not rounds:
        return None
    try:
        from repro_torch.launch.trace import TRACER
    except ImportError:
        return None
    lo, hi = min(a for a, _ in rounds), max(b for _, b in rounds)
    return TRACER.records(lo, hi), hi - lo


def durations(recs, name: str) -> np.ndarray:
    """Seconds of each closed record ``name``."""
    r = recs.where(name)
    d = r.t1 - r.t0
    return d[np.isfinite(d)]


def child_sums(recs, name: str, child: str) -> np.ndarray:
    """Seconds of each closed ``name`` record and, beside them, the summed
    seconds of its ``child`` records: an (n, 2) array."""
    r, c = recs.where(name), recs.where(child)
    done = np.isfinite(r.t1)
    own = dict(zip(r.index[done].tolist(), range(int(done.sum()))))
    out = np.zeros((len(own), 2))
    out[:, 0] = (r.t1 - r.t0)[done]
    for parent, d in zip(c.parent.tolist(), (c.t1 - c.t0).tolist()):
        if parent in own and np.isfinite(d):
            out[own[parent], 1] += d
    return out


def median_ms(seconds: np.ndarray):
    return 1e3 * float(np.median(seconds)) if len(seconds) else None
