"""Kernels layer: K2's least time for the work of its calls in the traced
window over its device time there, in % (:mod:`portbench.readers`)."""

from portbench.readers import kernel_roofline_pct


def read(ctx):
    return kernel_roofline_pct(ctx, "k2")
