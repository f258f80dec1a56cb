"""Kernels: ``bitgemm_packed``'s share of its roofline in the traced slice, in %
(``yardstick.kernel_roofline``)."""
from chipbench import yardstick


def read(ctx):
    return yardstick.kernel_roofline(ctx, "bitgemm_packed")
