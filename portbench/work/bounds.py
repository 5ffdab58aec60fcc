"""Peaks of one NVIDIA H100 SXM and the least time of a piece of work.

The published dense rates (NVIDIA's data sheet, at the 700 W limit):
3.35 TB/s of HBM, 67 TFLOP/s of float32 on the CUDA cores and 989
TFLOP/s of bf16 on the tensor cores. A bound is the larger of bytes over
the memory rate and operations over the peak that runs them.

The kernel bounds are those of the repository's kernel table (copied
from chip_smoke.py's ``bound`` helpers): each input byte read once, each
output byte written once, 8 operations per band candidate of a search;
the searches' selection work is not counted, so ``knn`` and ``knn_idw``
are lower bounds.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
PEAK_BF16 = 989e12

F32, BF16 = 4, 2


def bound(nbytes: float, flops: float,
          peak_ops: float = PEAK_F32) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations", whichever sets it)."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def scatter_bytes_ops(b, n, k, c, esize, n_out) -> tuple[float, float]:
    """scatter_add: idx and the values read once, the float32 output
    written once; one add per value."""
    return (b * (n * k * 4 + n * k * c * esize + n_out * c * 4),
            b * n * k * c)


def softmax_sum_bytes_ops(b, n, k, c, esize, n_out) -> tuple[float, float]:
    """scatter_softmax_sum: idx, the values and the float32 logits read
    once, the float32 sums and denominators written once; three operations
    per summed element."""
    return (b * (n * k * 4 + n * k * c * esize + n * k * 4
                 + n_out * (c + 1) * 4), b * n * k * (c + 1) * 3)


def regroup_bytes_ops(b, n, k, m, c, esize) -> tuple[float, float]:
    """regroup: idx and the rows read once, the grouped rows written."""
    return b * (n * k * 4 + m * c * esize + n * k * c * esize), 0.0


def group_bytes_ops(b, n, m, k, c, esize, wb) -> tuple[float, float]:
    """knn_group: clouds, feats, sqdist + idx and the grouped rows moved
    once; 8 operations per band candidate."""
    return (b * ((n + m) * 3 * 4 + m * c * esize + n * k * (2 * 4)
                 + n * k * c * esize), b * n * wb * 8)


def knn_bytes_ops(b, n, m, k, wb) -> tuple[float, float]:
    """knn: clouds read and sqdist + idx written once; 8 operations per
    band candidate."""
    return b * ((n + m) * 3 * 4 + n * k * (2 * 4)), b * n * wb * 8


def group2_bytes_ops(b, n, m, k, c, esize, wb) -> tuple[float, float]:
    """knn_group2: both searches' clouds, the shared feats, both sqdist +
    idx and both grouped tensors moved once."""
    return (b * (2 * (n + m) * 3 * 4 + m * c * esize
                 + 2 * (n * k * (2 * 4) + n * k * c * esize)),
            b * 2 * n * wb * 8)


def idw_bytes_ops(b, n, m, k, c, esize, wb) -> tuple[float, float]:
    """knn_idw: clouds, feats, the [N, C] output and sqdist + idx moved
    once; 8 operations per band candidate, 2 per mixed element."""
    return (b * ((n + m) * 3 * 4 + m * c * esize + n * c * esize
                 + n * k * (2 * 4)), b * (n * wb * 8 + n * k * c * 2))


def attention_bytes_ops(n, kk, c, esize=BF16) -> tuple[float, float]:
    """The dual-softmax attention of [n, kk, c] patches: two inputs read,
    two outputs written; S, q' and k' are 3 kk*kk*c multiply-adds a
    point."""
    return 4 * n * kk * c * esize, 2 * n * 3 * kk * kk * c


def cost_attention_bytes_ops(n, kk, c, c2) -> tuple[float, float]:
    """The fused cost-attention chain in bf16: S, q' and k', the weightnet
    on 2 kk rows and the aggregation, multiply-adds x 2; three [n, kk, c]
    inputs, the float32 weightnet, the [n, c] output and the [n, kk]
    logits."""
    flops = 2 * n * (3 * kk * kk * c + 2 * kk * (c * c + c * c2 + c2)
                     + kk * c)
    n_wn = c * c + c + c * c2 + c2 + c2 + 1
    nbytes = 3 * n * kk * c * 2 + n_wn * 4 + n * c * 2 + n * kk * 4
    return nbytes, flops
