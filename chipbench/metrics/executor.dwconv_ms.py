"""Model executor: the host's time in the depthwise convolutions of one
forward (the program's ``executor.dwconv`` spans inside each
``executor.plan``, summed), the median over the window's forwards, in ms.
None where the program records no such span."""
from chipbench import program_spans


def read(ctx):
    got = program_spans.window_records(ctx)
    if got is None or not len(got[0].where("executor.dwconv")):
        return None
    sums = program_spans.child_sums(got[0], "executor.plan",
                                    "executor.dwconv")
    return program_spans.median_ms(sums[:, 1])
