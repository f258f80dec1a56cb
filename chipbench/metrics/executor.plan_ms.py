"""Model executor: the host's enqueue of one forward, timed by the program
itself (its ``executor.plan`` spans), the median over the window's
forwards, in ms."""
from chipbench import program_spans


def read(ctx):
    got = program_spans.window_records(ctx)
    if got is None:
        return None
    return program_spans.median_ms(
        program_spans.durations(got[0], "executor.plan"))
