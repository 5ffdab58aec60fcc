"""Scan-to-scan point-to-plane Gauss-Newton odometry, the ONLY_PC variant
(ssf_slam_tpu/odometry/scan2scan.py; the lidarOdometry_onlyPC node,
src/lidarOdometry_onlyPC.cpp, with Ceres).

Per frame, the last cloud's local planes are fit once
(``fit_ring_diverse_planes``: 16-NN, the ring-diverse 5-point pick, a TLS
plane and its gates), then ``scan_to_scan`` solves for T_last_curr from two
anchors, the warm start and the BEV-correlation init
(``odometry/bev_init.py``), each with ``outer_iters`` re-associations of
``gn_iters`` damped Huber-IRLS steps. The JAX package's ``vmap`` over the
anchors is a leading dimension of the solve here; the hypothesis pick and
the inlier guard are selects on device tensors, and the 6x6 solves report
failure in an info tensor, so the whole solve runs without a host sync.
``PlaneModel`` and ``huber_weight`` also serve the scan-to-map refine and
``geom_refine``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ssf_slam_tpu_torch.config import OdometryConfig
from ssf_slam_tpu_torch.frontend.features import FeatureCloud
from ssf_slam_tpu_torch.ops.eig3 import smallest_eigvec_sym3
from ssf_slam_tpu_torch.ops.grouping import group_points
from ssf_slam_tpu_torch.ops.knn import knn, nearest_neighbor
from ssf_slam_tpu_torch.ops.se3 import (
    cross3,
    quat_conjugate,
    quat_from_rpy,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    so3_exp_quat,
    so3_log_quat,
)

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


def _ring_diverse_five(nbr_ring: Tensor, k: int) -> Tensor:
    """The 5 nearest, where among neighbours 5..k-1 on another ring than
    the nearest the first replaces slot 4 and the second slots 3 and 4
    (cpp:180-205). Returns [F, 5] int64 positions into the k neighbours.
    (The reference's gate on the n-th neighbour's distance is replaced by
    the farthest used point's, as in the JAX package.)"""
    f = nbr_ring.shape[0]
    pos = torch.arange(k, device=nbr_ring.device)[None, :]
    diff = ((nbr_ring != nbr_ring[:, 0:1]) & (pos >= 5) & (nbr_ring >= 0)
            & (nbr_ring <= 63))
    cum = torch.cumsum(diff.to(torch.int32), dim=1)
    first, second = diff & (cum == 1), diff & (cum == 2)
    has1, has2 = first.any(dim=1), second.any(dim=1)
    # the first True of each row (argmax returns the first maximum)
    i1 = torch.argmax(first.to(torch.int32), dim=1)
    i2 = torch.argmax(second.to(torch.int32), dim=1)
    base = torch.arange(5, device=nbr_ring.device).expand(f, 5)
    slot4 = torch.where(has2, i2, torch.where(has1, i1, base[:, 4]))
    slot3 = torch.where(has2, i1, base[:, 3])
    return torch.cat([base[:, :3], slot3[:, None], slot4[:, None]], dim=1)


def fit_ring_diverse_planes(cloud: FeatureCloud,
                            cfg: OdometryConfig = OdometryConfig()
                            ) -> PlaneModel:
    """Each point's local plane: ``cfg.knn_neighbors``-NN, the
    ring-diverse five, a TLS plane (the smallest eigenvector of their
    covariance) and its gates: coplanarity of consecutive pairs, the
    farthest used neighbour within max(max_fit_dist, range_gate_factor *
    range), and a middle eigenvalue above 1e-3 (two spanned directions)."""
    k = cfg.knn_neighbors
    d, idx = knn(cloud.xyz, cloud.xyz, k, points_mask=cloud.mask,
                 approx=True)
    slots = _ring_diverse_five(cloud.ring[idx], k)
    five_idx = torch.gather(idx, 1, slots)  # [F, 5]
    pts5 = group_points(cloud.xyz, five_idx)  # [F, 5, 3]
    used_dist = torch.gather(d, 1, slots)  # [F, 5]
    c5 = pts5 - torch.mean(pts5, dim=1, keepdim=True)
    cov = torch.einsum("fkc,fkd->fcd", c5, c5)
    evals, normal = smallest_eigvec_sym3(cov)
    proj = torch.abs(torch.einsum("fkc,fc->fk", pts5[:, :4] - pts5[:, 1:],
                                  normal))
    coplanar = torch.amax(proj, dim=1) <= cfg.coplanar_max
    limit = torch.clamp(cfg.range_gate_factor
                        * torch.linalg.norm(cloud.xyz, dim=-1),
                        min=cfg.max_fit_dist)
    within = torch.amax(used_dist, dim=1) < limit ** 2
    well_conditioned = evals[..., 1] > 1e-3
    five_valid = torch.all(cloud.mask[five_idx], dim=1)
    valid = cloud.mask & five_valid & coplanar & within & well_conditioned
    return PlaneModel(normal=normal, valid=valid)


def scan_to_scan(curr: FeatureCloud, last: FeatureCloud,
                 last_planes: PlaneModel, init_q: Tensor, init_t: Tensor,
                 cfg: OdometryConfig = OdometryConfig(),
                 curr_planes: PlaneModel | None = None
                 ) -> tuple[Tensor, Tensor, Tensor]:
    """T_last_curr (p_last = R(q) p_curr + t) from the warm start
    (init_q, init_t) and, with ``cfg.bev_init``, the BEV hypothesis; with
    ``curr_planes`` the association is normal-compatible (the nearest of
    ``assoc_neighbors`` last-frame planes, penalised by normal
    misalignment). Returns (q [4], t [3], n_inliers); the warm start when
    the picked solve had 10 or fewer inliers."""
    po = curr.xyz
    dev, dt = po.device, po.dtype
    last_valid = last.mask & last_planes.valid
    if cfg.bev_init:
        from ssf_slam_tpu_torch.odometry.bev_init import bev_pose_init

        rotated = quat_rotate(init_q[None], po)
        dyaw, shift = bev_pose_init(
            rotated, curr.mask, last.xyz, last.mask, pred_t=init_t,
            plaus_gate=cfg.bev_plaus_gate, plaus_rel=cfg.bev_plaus_rel)
        zero = torch.zeros_like(dyaw)
        bev_q = quat_multiply(quat_from_rpy(zero, zero, dyaw), init_q)
        bev_t = torch.cat([shift[:2], init_t[2:]])
        anchor_q = torch.stack([init_q, bev_q])
        anchor_t = torch.stack([init_t, bev_t])
    else:
        anchor_q, anchor_t = init_q[None], init_t[None]
    n_hyp, n_pts = anchor_q.shape[0], po.shape[0]

    def associate(q, t):
        """Per hypothesis [H]: (target points, normals, weight mask)."""
        warped = quat_rotate(q[:, None], po[None]) + t[:, None]  # [H, F, 3]
        flat = warped.reshape(n_hyp * n_pts, 3)
        if curr_planes is None:
            d_seed, seed = nearest_neighbor(flat, last.xyz,
                                            points_mask=last_valid)
        else:
            d, cand = knn(flat, last.xyz, cfg.assoc_neighbors,
                          points_mask=last_valid, approx=True)
            d = d.reshape(n_hyp, n_pts, -1)
            cand = cand.reshape(n_hyp, n_pts, -1)
            n_c = quat_rotate(q[:, None], curr_planes.normal[None])
            n_l = last_planes.normal[cand]  # [H, F, A, 3]
            align = torch.abs(torch.einsum("hfc,hfac->hfa", n_c, n_l))
            # no own normal: plain nearest
            align = torch.where(curr_planes.valid[None, :, None], align,
                                torch.ones_like(align))
            score = d + cfg.assoc_normal_penalty * (1.0 - align)
            j = torch.argmin(score, dim=-1, keepdim=True)
            seed = torch.gather(cand, -1, j)[..., 0]
            d_seed = torch.gather(d, -1, j)[..., 0]
        seed = seed.reshape(n_hyp, n_pts)
        d_seed = d_seed.reshape(n_hyp, n_pts)
        w_valid = (curr.mask[None] & last_valid[seed]
                   & (d_seed < cfg.assoc_max_dist ** 2))
        return last.xyz[seed], last_planes.normal[seed], w_valid

    def residual(q, t, pa, nrm):
        u = quat_rotate(q[:, None], po[None])  # [H, F, 3]
        return u, torch.einsum("hfc,hfc->hf", u + t[:, None] - pa, nrm)

    # range-dependent noise: sigma ~ 1 + (r / r0)^2 caps far points'
    # leverage on the rotation block
    w_range = 1.0 / (1.0 + (torch.linalg.norm(po, dim=-1)
                            / cfg.range_sigma_scale) ** 2)
    w_prior = torch.cat([
        torch.full((3,), cfg.prior_rot_weight, dtype=dt, device=dev),
        torch.full((3,), cfg.prior_trans_weight, dtype=dt, device=dev)])
    eye = torch.eye(6, dtype=dt, device=dev)
    q, t = anchor_q, anchor_t
    for _ in range(cfg.outer_iters):
        pa, nrm, w_valid = associate(q, t)
        for _ in range(cfg.gn_iters):
            u, r = residual(q, t, pa, nrm)
            w = huber_weight(r, cfg.huber_delta) * w_range * w_valid.to(dt)
            # J = [u x n, n] for the left perturbation R <- exp(w^) R
            jac = torch.cat([cross3(u, nrm), nrm], dim=-1)  # [H, F, 6]
            h = torch.einsum("hfi,hfj->hij", jac * w[..., None], jac)
            g = torch.einsum("hfi,hf->hi", jac, w * r)
            r_prior = torch.cat([
                so3_log_quat(quat_multiply(q, quat_conjugate(anchor_q))),
                t - anchor_t], dim=-1)
            h = h + torch.diag(w_prior)
            g = g + w_prior * r_prior
            h = (h + cfg.lm_lambda * torch.diag_embed(
                torch.diagonal(h, dim1=-2, dim2=-1)) + 1e-6 * eye)
            delta = -torch.linalg.solve_ex(h, g[..., None])[0][..., 0]
            # trust region: re-associate before trusting a large jump
            delta = torch.cat([
                torch.clamp(delta[:, :3], -cfg.max_rot_step,
                            cfg.max_rot_step),
                torch.clamp(delta[:, 3:], -cfg.max_trans_step,
                            cfg.max_trans_step)], dim=-1)
            q = quat_normalize(quat_multiply(so3_exp_quat(delta[:, :3]), q))
            t = t + delta[:, 3:]

    pa, nrm, w_valid = associate(q, t)
    n_ins = torch.sum(w_valid.to(torch.int32), dim=-1)  # [H]
    _, r = residual(q, t, pa, nrm)
    a, hd = torch.abs(r), cfg.huber_delta
    rho = torch.where(a <= hd, r * r, hd * (2.0 * a - hd))
    # mean Huber residual over the matched points; too few constraints
    # reject the hypothesis
    score = (torch.sum(rho * w_valid.to(dt), dim=-1)
             / torch.clamp(n_ins, min=1))
    score = score + torch.where(n_ins > 10, 0.0, 1e6)

    # the pick (OdometryConfig.hypothesis_pick): BEV by default; "score"
    # takes the warm solve only on a decisive aliasing event
    if n_hyp == 1 or cfg.hypothesis_pick == "warm":
        q, t, n_in = q[0], t[0], n_ins[0]
    elif cfg.hypothesis_pick == "bev":
        q, t, n_in = q[1], t[1], n_ins[1]
    else:
        separation = torch.linalg.norm(t[0] - t[1])
        decisive = ((score[0] < cfg.hyp_score_factor * score[1])
                    & (separation > cfg.hyp_separation_min)
                    & (n_ins[0] >= (0.8 * n_ins[1]).to(n_ins.dtype)))
        q = torch.where(decisive, q[0], q[1])
        t = torch.where(decisive, t[0], t[1])
        n_in = torch.where(decisive, n_ins[0], n_ins[1])
    # no hypothesis with enough constraints: keep the warm start
    ok = n_in > 10
    return torch.where(ok, q, init_q), torch.where(ok, t, init_t), n_in
