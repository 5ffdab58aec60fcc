"""The share (%) of the traced window in which no kernel or copy ran on
the device."""


def read(ctx):
    return ctx.idle_percent()
