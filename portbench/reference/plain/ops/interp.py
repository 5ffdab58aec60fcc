"""Inverse-distance-weighted kNN interpolation (ssf_slam_tpu/ops/interp.py):
the exact kNN (``ops/knn.py``) feeds weights ``(1/d) / sum(1/d)`` with the
distance softened by eps inside the sqrt (pointnet2's ``three_nn`` +
``three_interpolate``, soflow.py:1442-1475)."""

from __future__ import annotations

import torch


Tensor = torch.Tensor


def idw_weights(sqdist: Tensor, eps: float = 1e-2) -> Tensor:
    """[..., N, K] squared distances -> normalised inverse-distance weights.

    eps (1 cm) sits INSIDE the sqrt, as in the JAX package.
    """
    dist = torch.sqrt(torch.clamp(sqdist, min=0.0) + eps * eps)
    inv = 1.0 / dist
    return inv / torch.sum(inv, dim=-1, keepdim=True)
