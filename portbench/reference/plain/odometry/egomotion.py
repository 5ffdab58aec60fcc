"""Ego-motion from scene flow (ssf_slam_tpu/odometry/egomotion.py).

Given frame-1 points ``pts`` and flow into frame 2, the frame-to-frame
transform maps CURRENT (frame-2) coordinates back into the LAST frame:
Kabsch with src = pts + flow, dst = pts, so p_last = R p_curr + t. The
static points come from the network's seg head (SSF) or the classifier
(ssfc).
"""

from __future__ import annotations

import torch

from portbench.reference.plain.ops.kabsch import kabsch
from portbench.reference.plain.ops.se3 import matrix_to_quat, quat_rotate

Tensor = torch.Tensor


def ego_motion_from_flow(pts: Tensor, flow: Tensor, static_mask: Tensor,
                         irls_iters: int = 0,
                         irls_sigma: float = 0.05) -> tuple[Tensor, Tensor]:
    """Kabsch on static points, then ``irls_iters`` Cauchy-reweighted refits
    (weights w / (1 + (r / sigma)^2)). Returns (q [4], t [3])."""
    w = static_mask.to(pts.dtype)
    src = pts + flow
    r, t = kabsch(src, pts, w)
    for _ in range(irls_iters):
        res = pts - (src @ r.T + t[None, :])
        r2 = torch.sum(res * res, dim=-1)
        w_r = w / (1.0 + r2 / (irls_sigma * irls_sigma))
        r, t = kabsch(src, pts, w_r)
    return matrix_to_quat(r), t


def trim_static_mask(pts: Tensor, flow: Tensor, static: Tensor, q: Tensor,
                     t: Tensor, max_resid: float) -> Tensor:
    """``static`` restricted to points whose flow agrees with the rigid fit
    (q, t) within ``max_resid`` m: |pts - (R(q)(pts + flow) + t)|. This
    trimmed mask is what anchors geometry (the keyframe seg-gate)."""
    pred = quat_rotate(q[None], pts + flow) + t[None]
    r = pts - pred
    r2 = (r[:, 0] * r[:, 0] + r[:, 1] * r[:, 1]) + r[:, 2] * r[:, 2]
    return static & (r2 < max_resid * max_resid)
