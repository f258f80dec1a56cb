"""Serving engine: the self time of one bucket's harvest (the program's
``engine.harvest`` span without its ``engine.harvest.wait`` for the card:
building the bucket's results), the median over the window's buckets, in
ms."""
from chipbench import program_spans


def read(ctx):
    got = program_spans.window_records(ctx)
    if got is None:
        return None
    own = program_spans.child_sums(got[0], "engine.harvest",
                                   "engine.harvest.wait")
    return program_spans.median_ms(own[:, 0] - own[:, 1])
