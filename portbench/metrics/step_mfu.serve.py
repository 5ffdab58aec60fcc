"""The whole step's share (%) of the card's bf16 dense peak: the
network's matmul operations of a scan (``work/network.py``, the cached
tower counted once) times the scans of the traced window, over the
window."""

from portbench.work.bounds import PEAK_BF16


def read(ctx):
    if not ctx.units or ctx.window_s <= 0:
        return None
    flops = ctx.work["model_flops"] * ctx.units
    return 100.0 * flops / ctx.window_s / PEAK_BF16
