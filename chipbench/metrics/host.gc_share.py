"""Host: the share of the measured window's wall that the garbage
collector took (the program's ``host.gc`` records), in %."""
from chipbench import program_spans


def read(ctx):
    got = program_spans.window_records(ctx)
    if got is None or got[1] <= 0:
        return None
    recs, wall = got
    return 100.0 * float(program_spans.durations(recs, "host.gc").sum()) / wall
