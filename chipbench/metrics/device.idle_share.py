"""Device: the share of the traced slice's wall in which no operation ran
on a card, averaged over the cell's cards, in %."""
import numpy as np


def read(ctx):
    prof = ctx["profile"]
    if not prof or not prof.get("window_s"):
        return None
    return 100.0 * (1.0 - float(np.mean(prof["busy_s"])) / prof["window_s"])
