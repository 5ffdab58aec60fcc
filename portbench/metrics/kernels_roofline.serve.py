"""The network's share of its roofline (%): the least time the network's
work of the traced scans needs on the card (``work/network.py``) over
the device time of every kernel launched inside the network's spans
(``pb.tower``, ``pb.head``)."""


def read(ctx):
    kernels = ctx.trace.kernels_launched_in("tower", "head")
    device_us = sum(e - s for _, s, e, *_ in kernels)
    if device_us <= 0 or not ctx.units:
        return None
    return 100.0 * ctx.work["bound_ms"] * 1e3 * ctx.units / device_us
