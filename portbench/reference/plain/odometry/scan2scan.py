"""The plane model and the Huber weight of the scan-to-scan odometry
(ssf_slam_tpu_torch/odometry/scan2scan.py), which the keyframe back end's
scan-to-map refine uses."""

from __future__ import annotations

from typing import NamedTuple

import torch


Tensor = torch.Tensor


class PlaneModel(NamedTuple):
    """Per-point local plane of a cloud."""

    normal: Tensor  # [F, 3] unit normals
    valid: Tensor  # [F] bool: the fit passed its gates


def huber_weight(r: Tensor, delta: float) -> Tensor:
    """IRLS weight of the Huber loss (Ceres HuberLoss)."""
    a = torch.abs(r)
    return torch.where(a <= delta, torch.ones_like(a),
                       delta / torch.clamp(a, min=1e-12))
