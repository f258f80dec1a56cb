"""Model executor: the host's time in the norms of one forward (the
program's ``executor.norm`` spans inside each ``executor.plan``, summed),
the median over the window's forwards, in ms."""
from chipbench import program_spans


def read(ctx):
    got = program_spans.window_records(ctx)
    if got is None:
        return None
    sums = program_spans.child_sums(got[0], "executor.plan", "executor.norm")
    return program_spans.median_ms(sums[:, 1])
