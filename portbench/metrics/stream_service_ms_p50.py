"""The median over the measured window's scans (streamed untraced, before
the traced drive) of the runner's own latency: from when it picked a scan
up to when the pose was on the host."""

from portbench.trace import median


def read(ctx):
    service = ctx.stats.get("service_ms")
    return None if service is None or not len(service) else median(
        list(service))
