"""Kernels: ``conv_implicit``'s share of its roofline in the traced slice, in %
(``yardstick.kernel_roofline``)."""
from chipbench import yardstick


def read(ctx):
    return yardstick.kernel_roofline(ctx, "conv_implicit")
