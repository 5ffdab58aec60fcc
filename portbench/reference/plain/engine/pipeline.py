"""The per-scan SLAM step of the SSF variant
(ssf_slam_tpu_torch/engine/pipeline.py, SSF's branch):

    plane features -> IRLS Kabsch under the static mask -> odometry
    integration -> seg-gated keyframe mapping (+ scan-to-map refine, loop
    closure, pose graph)
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.plain.config import PipelineConfig
from portbench.reference.plain.frontend.features import (
    FeatureCloud,
    extract_plane_features,
)
from portbench.reference.plain.mapping.keyframes import (
    MapState,
    init_map_state,
    mapping_step,
)
from portbench.reference.plain.odometry.egomotion import (
    ego_motion_from_flow,
    trim_static_mask,
)
from portbench.reference.plain.ops.se3 import (
    pose_compose,
    quat_identity,
    quat_normalize,
)

Tensor = torch.Tensor


class SlamState(NamedTuple):
    """Carry of the per-scan step."""

    have_last: bool  # first-frame gate
    odom_q: Tensor  # [4] integrated frame odometry (q_0_curr)
    odom_t: Tensor  # [3]
    map_state: MapState


def init_slam_state(cfg: PipelineConfig, device) -> SlamState:
    return SlamState(
        have_last=False, odom_q=quat_identity(device),
        odom_t=torch.zeros(3, device=device),
        map_state=init_map_state(cfg.mapping.max_keyframes,
                                 cfg.features.max_features,
                                 refine_stride=cfg.mapping.refine_stride,
                                 device=device))


DYN_BUDGET = 1024  # compacted mover-point budget of the keyframe seg-gate


def near_dynamic(feat_xyz: Tensor, warped: Tensor, dyn: Tensor,
                 radius: float) -> Tensor:
    """[F] bool: features within ``radius`` of any dynamic point; the
    dynamic points are compacted (in order) to ``DYN_BUDGET`` rows, the
    rest dropped."""
    slot = torch.cumsum(dyn.long(), 0) - 1
    idx = torch.where(dyn & (slot < DYN_BUDGET), slot, DYN_BUDGET)
    compact = torch.full((DYN_BUDGET + 1, 3), 1e6, dtype=warped.dtype,
                         device=warped.device)
    compact = compact.index_copy_(0, idx, warped)[:DYN_BUDGET]
    f2 = (feat_xyz * feat_xyz).sum(-1, keepdim=True)
    c2 = (compact * compact).sum(-1)[None, :]
    d2 = f2 - 2.0 * (feat_xyz @ compact.T) + c2
    return dyn.any() & (torch.amin(d2, dim=-1) < radius * radius)


def slam_step(state: SlamState, scan: dict,
              cfg: PipelineConfig) -> tuple[SlamState, dict]:
    """One scan {points [N, 3], mask [N], time, flow_points [N, 3],
    flow_mask [N], flow [N, 3], static_mask [N]} (the flow of the pair
    (k-1, k)) -> (state, outputs)."""
    feat: FeatureCloud = extract_plane_features(
        scan["points"], scan["mask"], cfg.lidar, cfg.features)
    dev = feat.xyz.device
    pts, mask, flow = scan["flow_points"], scan["flow_mask"], scan["flow"]
    ego = cfg.egomotion
    if state.have_last:
        static = scan["static_mask"] & mask
        rel_q, rel_t = ego_motion_from_flow(pts, flow, static,
                                            irls_iters=ego.irls_iters,
                                            irls_sigma=ego.irls_sigma)
    else:  # no pair yet: everything counts as static for the map gate
        rel_q, rel_t = quat_identity(dev), torch.zeros(3, device=dev)
        static = torch.ones_like(mask)

    kf_mask = feat.mask
    if cfg.mapping.seg_gate_keyframes:
        static_trim = trim_static_mask(pts, flow, static, rel_q, rel_t,
                                       ego.refine_trim_resid)
        dyn = mask & ~static_trim
        kf_mask = feat.mask & ~near_dynamic(feat.xyz, pts + flow, dyn,
                                            cfg.mapping.seg_gate_radius)

    odom_q, odom_t = pose_compose((state.odom_q, state.odom_t),
                                  (rel_q, rel_t))
    odom_q = quat_normalize(odom_q)
    map_state, map_out = mapping_step(state.map_state, odom_q, odom_t,
                                      feat.xyz, kf_mask, scan["time"],
                                      cfg.mapping)
    new_state = SlamState(have_last=True, odom_q=odom_q, odom_t=odom_t,
                          map_state=map_state)
    outputs = dict(pose_q=map_out["pose_q"], pose_t=map_out["pose_t"],
                   rel_q=rel_q, rel_t=rel_t,
                   is_keyframe=map_out["is_keyframe"])
    return new_state, outputs


def stack_outputs(outs: list[dict]) -> dict:
    """Per-scan outputs -> numpy arrays over frames."""
    res = {}
    for key in outs[0]:
        if key == "is_keyframe":
            res[key] = np.asarray([bool(o[key]) for o in outs], bool)
            continue
        res[key] = torch.stack([o[key] for o in outs]).float().cpu().numpy()
    return res
