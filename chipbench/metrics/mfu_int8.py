"""Model step: 2 x the network's multiply-accumulates x the images of the
traced slice, over its wall seconds, over the int8 peak of the cell's
cards, in %.  The operations come from the network's shapes alone."""
from chipbench import yardstick


def read(ctx):
    prof = ctx["profile"]
    if not prof or not prof.get("window_s"):
        return None
    macs = yardstick.count_macs(ctx["layers"], ctx["cfg"]["img_hw"])
    rate = 2.0 * macs * prof["images"] / prof["window_s"]
    return 100.0 * rate / (yardstick.PEAK_INT8_OPS * ctx["chips"])
