"""Model executor: the host wall of one forward call of the program's
runner (enqueue, no synchronisation), the median over the window's
forward spans, in ms."""
import numpy as np


def read(ctx):
    d = [b - a for name, a, b in ctx["spans"] if name == "executor.forward"]
    return 1e3 * float(np.median(d)) if d else None
