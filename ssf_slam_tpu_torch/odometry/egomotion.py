"""Ego-motion from scene flow (ssf_slam_tpu/odometry/egomotion.py).

Given frame-1 points ``pts`` and flow into frame 2, the frame-to-frame
transform maps CURRENT (frame-2) coordinates back into the LAST frame:
Kabsch with src = pts + flow, dst = pts, so p_last = R p_curr + t. The
static points come from the ground-truth mask (SEG), a GMM split over
[flow || xyz] (NO_SEG, SF) or the network's seg head (SSF).
"""

from __future__ import annotations

import torch

from ssf_slam_tpu_torch.config import EgoMotionConfig
from ssf_slam_tpu_torch.ops.gmm import gmm_background_mask
from ssf_slam_tpu_torch.ops.kabsch import kabsch
from ssf_slam_tpu_torch.ops.se3 import matrix_to_quat, quat_rotate

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


def ego_motion_gt_seg(pts: Tensor, flow: Tensor, fg_mask: Tensor,
                      valid: Tensor) -> tuple[Tensor, Tensor]:
    """SEG: the ground-truth foreground mask gates the movers
    (scripts/PointCloudOdometry.py:91); one unweighted Kabsch."""
    return ego_motion_from_flow(pts, flow, (fg_mask < 0.5) & valid)


def ego_motion_gmm(pts: Tensor, flow: Tensor, valid: Tensor,
                   cfg: EgoMotionConfig = EgoMotionConfig()
                   ) -> tuple[Tensor, Tensor, Tensor]:
    """NO_SEG / SF: the GMM background over [flow || xyz], then the
    IRLS Kabsch on it. Returns (q, t, background mask)."""
    bg = gmm_background_mask(torch.cat([flow, pts], dim=-1), mask=valid,
                             n_iters=cfg.gmm_iters)
    q, t = ego_motion_from_flow(pts, flow, bg, irls_iters=cfg.irls_iters,
                                irls_sigma=cfg.irls_sigma)
    return q, t, bg
