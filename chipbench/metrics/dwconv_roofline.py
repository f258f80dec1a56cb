"""Kernels: ``dwconv``'s share of its roofline in the traced slice, in %:
the bounds of its calls over their profiled time.  The layers it serves
are the depthwise ones (``groups`` > 1) on the ``depthwise`` engine; each
call's bound is its layer's at the replica's batch: the (B, H, W, C)
levels read once, the (9, C) weights once and the (B, OH, OW, C) float32
output written once, at the published memory rate (its 9 multiply-adds
an output sit far below the card's integer rate).  ``layer_shapes``
counts a depthwise layer's input as its one channel a group, so the bytes
in are taken with C channels here.  None where the slice holds no call
of it."""
from chipbench import yardstick


def depthwise_bound_ms(s) -> float:
    """One call's least time: bytes at 3.35 TB/s (``s`` a
    ``yardstick.Shape``, whose ``cout`` is the channel count)."""
    nbytes = (s.batch * s.in_h * s.in_w * s.cout + s.k * s.k * s.cout
              + 4 * s.batch * s.out_h * s.out_w * s.cout)
    return yardstick.bound_ms(0.0, nbytes)


def read(ctx):
    prof = ctx["profile"]
    if not prof:
        return None
    sec = calls = 0
    for name, (s, n) in prof["by_kernel"].items():
        if "dwconv_" in name and "_kernel" in name:
            sec, calls = sec + s, calls + n
    cfg = ctx["cfg"]
    shapes = yardstick.layer_shapes(ctx["layers"], cfg["img_hw"],
                                    ctx["replica_batch"])
    served = [s for s, l, (eng, fp) in zip(shapes, ctx["layers"],
                                           ctx["plan_layers"])
              if not fp and eng == "depthwise" and getattr(l, "groups", 1) > 1]
    if not calls or not served:
        return None
    per_call_ms = sum(map(depthwise_bound_ms, served)) / len(served)
    return 100.0 * calls * per_call_ms * 1e-3 / sec
