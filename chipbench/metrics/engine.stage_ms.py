"""Serving engine: the host's staging of one bucket (collate, pin, the
copy's enqueue: the program's ``engine.stage`` spans), the median over the
window's buckets, in ms."""
from chipbench import program_spans


def read(ctx):
    got = program_spans.window_records(ctx)
    if got is None:
        return None
    return program_spans.median_ms(
        program_spans.durations(got[0], "engine.stage"))
