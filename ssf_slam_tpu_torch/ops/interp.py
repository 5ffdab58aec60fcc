"""Inverse-distance-weighted kNN interpolation (ssf_slam_tpu/ops/interp.py):
the exact kNN (``ops/knn.py``) feeds weights ``(1/d) / sum(1/d)`` with the
distance softened by eps inside the sqrt (pointnet2's ``three_nn`` +
``three_interpolate``, soflow.py:1442-1475)."""

from __future__ import annotations

import torch

from ssf_slam_tpu_torch.ops.grouping import group_points
from ssf_slam_tpu_torch.ops.knn import knn

Tensor = torch.Tensor


def idw_weights(sqdist: Tensor, eps: float = 1e-2) -> Tensor:
    """[..., N, K] squared distances -> normalised inverse-distance weights.

    eps (1 cm) sits INSIDE the sqrt, as in the JAX package.
    """
    dist = torch.sqrt(torch.clamp(sqdist, min=0.0) + eps * eps)
    inv = 1.0 / dist
    return inv / torch.sum(inv, dim=-1, keepdim=True)


def knn_interpolate(dense_xyz: Tensor, sparse_xyz: Tensor,
                    sparse_feats: Tensor, k: int = 3,
                    sparse_mask: Tensor | None = None,
                    clamp: float | None = None) -> Tensor:
    """Sparse per-point features onto dense positions: dense_xyz
    [..., N, 3], sparse_xyz [..., S, 3], sparse_feats [..., S, C] ->
    [..., N, C], optionally clamped to [-clamp, clamp] (UpsampleFlow's
    clamp(-100, 100), soflow.py:1474)."""
    d, idx = knn(dense_xyz, sparse_xyz, k, points_mask=sparse_mask)
    w = idw_weights(d)
    out = torch.sum(w[..., None] * group_points(sparse_feats, idx), dim=-2)
    if clamp is not None:
        out = torch.clamp(out, -clamp, clamp)
    return out


def three_nn_interpolate(dense_xyz: Tensor, sparse_xyz: Tensor,
                         sparse_feats: Tensor,
                         sparse_mask: Tensor | None = None,
                         clamp: float | None = None) -> Tensor:
    """The 3-NN case (pointnet2's ``three_nn`` + ``three_interpolate``)."""
    return knn_interpolate(dense_xyz, sparse_xyz, sparse_feats, k=3,
                           sparse_mask=sparse_mask, clamp=clamp)
