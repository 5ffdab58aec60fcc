"""Farthest point sampling (ssf_slam_tpu/ops/fps.py), strided-bucketed.

The cloud is split into G strided buckets (point i belongs to bucket
i % G) and exact FPS runs in every bucket at once, each picking npoint / G
samples. This is the JAX package's algorithm, not global FPS: the SA points
it picks, and so everything downstream, depend on it. ``argmax`` takes the
first maximum, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _pick_groups(n: int, npoint: int) -> int:
    """Largest G <= 64 dividing both n and npoint (>= 8 samples per group)."""
    g = 64
    while g > 1 and (n % g or npoint % g or npoint // g < 8):
        g //= 2
    return g


def _fps_exact(pts: Tensor, npoint: int) -> Tensor:
    """pts [R, n, 3] -> [R, npoint] int64: start at index 0, then the
    running-min-distance argmax."""
    r, n, _ = pts.shape
    rows = torch.arange(r, device=pts.device)
    dist = torch.full((r, n), float("inf"), device=pts.device)
    idxs = torch.zeros((r, npoint), dtype=torch.int64, device=pts.device)
    last = torch.zeros((r,), dtype=torch.int64, device=pts.device)
    for i in range(1, npoint):
        diff = pts - pts[rows, last][:, None, :]
        d = (diff[..., 0] * diff[..., 0]
             + diff[..., 1] * diff[..., 1]) + diff[..., 2] * diff[..., 2]
        dist = torch.minimum(dist, d)
        last = torch.argmax(dist, dim=-1)
        idxs[:, i] = last
    return idxs


def farthest_point_sample(xyz: Tensor, npoint: int) -> Tensor:
    """xyz [B, N, 3] -> FPS indices [B, npoint] int64."""
    b, n, _ = xyz.shape
    groups = _pick_groups(n, npoint)
    chunk, per = n // groups, npoint // groups
    # bucket g holds points g, g + G, g + 2G, ... (local index i // G)
    gx = xyz.reshape(b, chunk, groups, 3).transpose(1, 2)
    local = _fps_exact(gx.reshape(b * groups, chunk, 3), per)
    offset = torch.arange(groups, device=xyz.device)[:, None]
    return (local.view(b, groups, per) * groups + offset).reshape(b, npoint)
