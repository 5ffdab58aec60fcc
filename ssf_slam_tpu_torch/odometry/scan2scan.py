"""The pieces of ssf_slam_tpu/odometry/scan2scan.py the SSF back end uses:
the per-point plane model and the Huber IRLS weight. The scan-to-scan
Gauss-Newton itself serves ONLY_PC and ``geom_refine`` and is not ported.
"""

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
