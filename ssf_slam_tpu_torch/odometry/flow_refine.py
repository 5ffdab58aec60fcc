"""Seg-gated geometric refinement of the flow ego-motion pose, the
``geom_refine`` option of the flow variants
(ssf_slam_tpu/odometry/flow_refine.py).

The flow pose inherits the flow's spatially correlated error; geometry
does not. The pose is re-registered by point-to-plane Gauss-Newton: the
sources are strided rows of the previous cloud under the residual-trimmed
static mask, the targets the current scan's ring-diverse planar features.
The flow pose is the init and the prior's anchor, and three acceptance
gates (inlier count, translation and rotation change) ship the flow pose
unchanged when geometry is degenerate. The gates are selects and the 6x6
solves report failure in an info tensor: no host sync.
"""

from __future__ import annotations

import torch

from ssf_slam_tpu_torch.config import EgoMotionConfig
from ssf_slam_tpu_torch.frontend.features import FeatureCloud
from ssf_slam_tpu_torch.odometry.scan2scan import PlaneModel, huber_weight
from ssf_slam_tpu_torch.ops.knn import nearest_neighbor
from ssf_slam_tpu_torch.ops.se3 import (
    cross3,
    quat_conjugate,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    so3_exp_quat,
    so3_log_quat,
)

Tensor = torch.Tensor


def refine_flow_pose(prev_pts: Tensor, static_w: Tensor,
                     curr_feat: FeatureCloud, curr_planes: PlaneModel,
                     q0: Tensor, t0: Tensor,
                     cfg: EgoMotionConfig = EgoMotionConfig()
                     ) -> tuple[Tensor, Tensor]:
    """Refine the flow pose (q0, t0), p_last = R(q0) p_curr + t0, from
    prev_pts [N, 3] (the flow pair's frame-1 cloud) under ``static_w`` [N]
    against the current features and their planes. Returns (q, t) in the
    same convention; (q0, t0) whenever a gate fails."""
    # solve prev -> curr, where the planes live: p_curr = R(qi) p_prev + ti
    qi0 = quat_conjugate(q0)
    ti0 = -quat_rotate(qi0[None], t0[None])[0]
    # strided sources: scan order spans all rings and azimuths
    src = prev_pts[::cfg.refine_src_stride]
    w_src = static_w[::cfg.refine_src_stride].to(prev_pts.dtype)
    tgt_valid = curr_feat.mask & curr_planes.valid
    w_range = 1.0 / (1.0 + (torch.linalg.norm(src, dim=-1) / 30.0) ** 2)
    dev, dt = src.device, src.dtype
    w_prior = torch.cat([
        torch.full((3,), cfg.refine_prior_rot, dtype=dt, device=dev),
        torch.full((3,), cfg.refine_prior_trans, dtype=dt, device=dev)])
    prior, eye = torch.diag(w_prior), torch.eye(6, dtype=dt, device=dev)

    def associate(q, t):
        y = quat_rotate(q[None], src) + t[None]
        d, seed = nearest_neighbor(y, curr_feat.xyz, points_mask=tgt_valid)
        ok = ((w_src > 0) & tgt_valid[seed]
              & (d < cfg.refine_assoc_max_dist ** 2))
        return curr_feat.xyz[seed], curr_planes.normal[seed], ok

    qi, ti = qi0, ti0
    for _ in range(cfg.refine_outer):
        pa, nrm, ok = associate(qi, ti)
        for _ in range(cfg.refine_gn_iters):
            u = quat_rotate(qi[None], src)
            r = torch.einsum("fc,fc->f", u + ti[None] - pa, nrm)
            w = (huber_weight(r, cfg.refine_huber) * w_range * w_src
                 * ok.to(dt))
            jac = torch.cat([cross3(u, nrm), nrm], dim=-1)  # [S, 6]
            h = (torch.einsum("fi,fj->ij", jac * w[:, None], jac) + prior
                 + 1e-6 * eye)
            # the prior anchored at the flow pose: geometry corrects it
            # only where the planes constrain the correction
            g = (torch.einsum("fi,f->i", jac, w * r) + w_prior * torch.cat([
                so3_log_quat(quat_multiply(qi, quat_conjugate(qi0))),
                ti - ti0]))
            delta = -torch.linalg.solve_ex(h, g)[0]
            delta = torch.cat([
                torch.clamp(delta[:3], -cfg.refine_max_rot_step,
                            cfg.refine_max_rot_step),
                torch.clamp(delta[3:], -cfg.refine_max_trans_step,
                            cfg.refine_max_trans_step)])
            qi = quat_normalize(quat_multiply(so3_exp_quat(delta[:3]), qi))
            ti = ti + delta[3:]

    _, _, ok = associate(qi, ti)
    n_inliers = torch.sum(ok.to(torch.int32))
    # back to p_last = R p_curr + t
    q = quat_conjugate(qi)
    t = -quat_rotate(q[None], ti[None])[0]
    d_trans = torch.linalg.norm(t - t0)
    d_rot = torch.linalg.norm(so3_log_quat(quat_multiply(q,
                                                         quat_conjugate(q0))))
    accept = ((n_inliers >= cfg.refine_min_inliers)
              & (d_trans <= cfg.refine_max_trans)
              & (d_rot <= cfg.refine_max_rot))
    return torch.where(accept, q, q0), torch.where(accept, t, t0)
