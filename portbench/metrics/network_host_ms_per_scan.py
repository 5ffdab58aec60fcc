"""Host time inside the network's spans (``pb.tower``, ``pb.head``), per
scan."""


def read(ctx):
    us = ctx.trace.span_us("tower", "head")
    return us * 1e-3 / ctx.units if us and ctx.units else None
