"""Kernels the device ran in the traced window, per scan."""


def read(ctx):
    if not ctx.trace.kernels or not ctx.units:
        return None
    return len(ctx.trace.kernels) / ctx.units
