"""How late the runner picked scans up: the 95th percentile over the
measured window's scans (streamed untraced, before the traced drive) of
the time from when a scan was due to when the runner took it."""

import numpy as np


def read(ctx):
    lag = ctx.stats.get("lag_ms")
    return None if lag is None or not len(lag) else float(
        np.percentile(lag, 95))
