"""Host waits on the device in the traced window (stream, event and
device synchronizes, synchronous copies), per scan."""


def read(ctx):
    if not ctx.trace.runtime or not ctx.units:
        return None
    return ctx.trace.syncs() / ctx.units
