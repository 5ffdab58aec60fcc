"""Masked point-to-point ICP (ssf_slam_tpu/ops/icp.py), the loop-closure
registration: a fixed number of 1-NN association + weighted Kabsch
iterations with a correspondence-distance gate, and the PCL-style fitness
(mean squared distance of in-range correspondences)."""

from __future__ import annotations

import torch

from portbench.reference.plain.ops.kabsch import kabsch
from portbench.reference.plain.ops.knn import nearest_neighbor

Tensor = torch.Tensor


def icp_point_to_point(source: Tensor, target: Tensor, source_mask: Tensor,
                       target_mask: Tensor, max_corr_dist: float = 50.0,
                       iters: int = 30):
    """Align source [N, 3] onto target [M, 3] from the identity. Returns
    (R [3, 3], t [3], fitness) with aligned = source @ R.T + t."""
    max2 = max_corr_dist * max_corr_dist
    r = torch.eye(3, dtype=source.dtype, device=source.device)
    t = torch.zeros(3, dtype=source.dtype, device=source.device)
    for _ in range(iters):
        moved = source @ r.T + t
        d2, idx = nearest_neighbor(moved, target, points_mask=target_mask,
                                   approx=True)
        w = (source_mask & (d2 < max2)).to(source.dtype)
        r_new, t_new = kabsch(moved, target[idx], w)
        r, t = r_new @ r, r_new @ t + t_new
    moved = source @ r.T + t
    d2, _ = nearest_neighbor(moved, target, points_mask=target_mask,
                             approx=True)
    w = (source_mask & (d2 < max2)).to(source.dtype)
    fitness = torch.sum(d2 * w) / torch.clamp(torch.sum(w), min=1.0)
    return r, t, fitness
