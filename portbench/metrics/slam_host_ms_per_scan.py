"""Host time inside the SLAM step's span (``pb.slam_step``), per scan."""


def read(ctx):
    us = ctx.trace.span_us("slam_step")
    return us * 1e-3 / ctx.units if us and ctx.units else None
