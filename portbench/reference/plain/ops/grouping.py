"""Index gather / neighbourhood grouping (ssf_slam_tpu/ops/grouping.py),
channels-last."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def gather_points(points: Tensor, idx: Tensor) -> Tensor:
    """points [..., N, C], idx [..., S] int -> [..., S, C]."""
    idx = idx.long()[..., None].expand(*idx.shape, points.shape[-1])
    return torch.gather(points, -2, idx)


def group_points(points: Tensor, idx: Tensor) -> Tensor:
    """points [..., N, C], idx [..., S, K] int -> [..., S, K, C]."""
    s, k = idx.shape[-2], idx.shape[-1]
    flat = idx.reshape(idx.shape[:-2] + (s * k,))
    out = gather_points(points, flat)
    return out.reshape(idx.shape[:-2] + (s, k, points.shape[-1]))
