"""Serving engine: how long a closed bucket waited before its forward
started (the program's ``engine.ready_wait`` records), the median over the
window's buckets, in ms."""
from chipbench import program_spans


def read(ctx):
    got = program_spans.window_records(ctx)
    if got is None:
        return None
    return program_spans.median_ms(
        program_spans.durations(got[0], "engine.ready_wait"))
