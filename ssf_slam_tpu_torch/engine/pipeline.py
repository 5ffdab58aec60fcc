"""The per-scan SLAM step (ssf_slam_tpu/engine/pipeline.py):

    plane features -> frame motion by variant -> odometry integration ->
    keyframe mapping (+ scan-to-map refine, loop closure, pose graph)

The frame motion by ``PipelineConfig.variant``:
- ONLY_PC: scan-to-scan point-to-plane Gauss-Newton against a local map of
  the last ``local_map_scans`` feature clouds, from the warm start and the
  BEV init (``odometry/scan2scan.py``);
- SEG: the ground-truth mask on a provided flow, then Kabsch;
- NO_SEG, SF: a GMM split of [flow || xyz], then IRLS Kabsch (SF's flow is
  TFlow's, run in ``engine/fused.py``);
- SSF: the network's static mask, then IRLS Kabsch.
With ``EgoMotionConfig.geom_refine`` SF and SSF refine the flow pose
against the current scan's ring-diverse planes (``odometry/flow_refine.py``),
and those planes become the keyframe's stored normals. The flow variants
seg-gate the stored keyframe cloud. The JAX package's ``lax.cond`` on the
first-frame gate is a host bool here.

Under a profiler (``utils/logging.py::span``) the step's stages are the
ranges ``ssf.features``, ``ssf.ego_motion``, ``ssf.seg_gate`` and
``ssf.mapping``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ssf_slam_tpu_torch.config import PipelineConfig, Variant
from ssf_slam_tpu_torch.device import resolve_device
from ssf_slam_tpu_torch.frontend.features import (
    FeatureCloud,
    extract_plane_features,
)
from ssf_slam_tpu_torch.mapping.keyframes import (
    MapState,
    init_map_state,
    mapping_step,
)
from ssf_slam_tpu_torch.odometry.egomotion import (
    ego_motion_from_flow,
    ego_motion_gmm,
    ego_motion_gt_seg,
    trim_static_mask,
)
from ssf_slam_tpu_torch.odometry.flow_refine import refine_flow_pose
from ssf_slam_tpu_torch.odometry.scan2scan import (
    PlaneModel,
    fit_ring_diverse_planes,
    scan_to_scan,
)
from ssf_slam_tpu_torch.ops.precision import set_geom_precision
from ssf_slam_tpu_torch.ops.se3 import (
    pose_compose,
    quat_conjugate,
    quat_identity,
    quat_normalize,
    quat_rotate,
)
from ssf_slam_tpu_torch.utils.logging import span

Tensor = torch.Tensor


class SlamState(NamedTuple):
    """Carry of the per-scan step."""

    last_feat: FeatureCloud  # ONLY_PC: the local map, in the last frame
    last_planes: PlaneModel  # ONLY_PC: the local map's planes
    have_last: bool  # first-frame gate
    odom_q: Tensor  # [4] integrated frame odometry (q_0_curr)
    odom_t: Tensor  # [3]
    vel_q: Tensor  # [4] last frame-to-frame motion: the warm start
    vel_t: Tensor  # [3]
    map_state: MapState


def init_slam_state(cfg: PipelineConfig,
                    device: str | torch.device = "cuda") -> SlamState:
    device = resolve_device(device)
    f = cfg.features.max_features
    # ONLY_PC registers against the last local_map_scans feature clouds
    m = f * (cfg.odometry.local_map_scans
             if cfg.variant == Variant.ONLY_PC else 1)
    qid = quat_identity(device)
    return SlamState(
        last_feat=FeatureCloud(
            xyz=torch.zeros(m, 3, device=device),
            ring=torch.zeros(m, dtype=torch.int32, device=device),
            mask=torch.zeros(m, dtype=torch.bool, device=device)),
        last_planes=PlaneModel(
            normal=torch.zeros(m, 3, device=device),
            valid=torch.zeros(m, dtype=torch.bool, device=device)),
        have_last=False, odom_q=qid, odom_t=torch.zeros(3, device=device),
        vel_q=qid, vel_t=torch.zeros(3, device=device),
        map_state=init_map_state(cfg.mapping.max_keyframes, f,
                                 refine_stride=cfg.mapping.refine_stride,
                                 device=device))


def _frame_motion(state: SlamState, scan: dict, feat: FeatureCloud,
                  feat_planes: PlaneModel | None, cfg: PipelineConfig):
    """T_last_curr by variant: (q, t, static mask over
    ``scan["flow_points"]``, None for ONLY_PC). The flow variants use the
    previous pair's (points, flow): pair (k-1, k) gives frame k's motion.
    ``geom_refine`` anchors the refine on the residual-trimmed mask."""
    variant, ego = cfg.variant, cfg.egomotion
    if variant == Variant.ONLY_PC:
        q, t, _ = scan_to_scan(feat, state.last_feat, state.last_planes,
                               state.vel_q, state.vel_t, cfg.odometry,
                               curr_planes=feat_planes)
        return q, t, None
    pts, mask, flow = scan["flow_points"], scan["flow_mask"], scan["flow"]
    if variant == Variant.SEG:
        q, t = ego_motion_gt_seg(pts, flow, scan["fg_mask"], mask)
        return q, t, (scan["fg_mask"] < 0.5) & mask
    if variant in (Variant.NO_SEG, Variant.SF):
        q, t, bg = ego_motion_gmm(pts, flow, mask, ego)
        static = bg & mask
        refine = variant == Variant.SF and ego.geom_refine
    elif variant == Variant.SSF:
        static = scan["static_mask"] & mask
        q, t = ego_motion_from_flow(pts, flow, static,
                                    irls_iters=ego.irls_iters,
                                    irls_sigma=ego.irls_sigma)
        refine = ego.geom_refine
    else:
        raise ValueError(variant)
    if refine:
        anchor = trim_static_mask(pts, flow, static, q, t,
                                  ego.refine_trim_resid)
        q, t = refine_flow_pose(pts, anchor, feat, feat_planes, q, t, ego)
    return q, t, static


DYN_BUDGET = 1024  # compacted mover-point budget of the keyframe seg-gate


def near_dynamic(feat_xyz: Tensor, warped: Tensor, dyn: Tensor,
                 radius: float) -> Tensor:
    """[F] bool: features within ``radius`` of any dynamic point. The
    dynamic points are compacted (in order) to ``DYN_BUDGET`` rows, the rest
    filled with 1e6; points past the budget are dropped, as in the JAX
    package. No host sync."""
    slot = torch.cumsum(dyn.long(), 0) - 1
    idx = torch.where(dyn & (slot < DYN_BUDGET), slot, DYN_BUDGET)
    compact = torch.full((DYN_BUDGET + 1, 3), 1e6, dtype=warped.dtype,
                         device=warped.device)
    # every dropped point lands in the extra row, which is cut off
    compact = compact.index_copy_(0, idx, warped)[:DYN_BUDGET]
    f2 = (feat_xyz * feat_xyz).sum(-1, keepdim=True)
    c2 = (compact * compact).sum(-1)[None, :]
    d2 = f2 - 2.0 * (feat_xyz @ compact.T) + c2
    return dyn.any() & (torch.amin(d2, dim=-1) < radius * radius)


def slam_step(state: SlamState, scan: dict,
              cfg: PipelineConfig) -> tuple[SlamState, dict]:
    """One scan: {points [N, 3], mask [N], time} and, for the flow
    variants, {flow_points [N, 3], flow_mask [N], flow [N, 3]} of the
    previous pair (frame k-1 -> k), with SEG's ``fg_mask`` [N] or SSF's
    ``static_mask`` [N]. Returns (state, outputs) with the map pose
    ``pose_q/pose_t``, the odometry ``odom_q/odom_t``, the frame motion
    ``rel_q/rel_t``, ``is_keyframe`` (host bool), ``n_features`` and
    ``n_dyn_over`` (0-d tensors)."""
    flow_variant = cfg.variant != Variant.ONLY_PC
    with span("features"):
        feat = extract_plane_features(scan["points"], scan["mask"],
                                      cfg.lidar, cfg.features)
        # the current scan's planes: ONLY_PC's odometry and geom_refine's
        # target; otherwise the keyframe branch fits the strided rows'
        # normals
        curr_planes = None
        if not flow_variant or cfg.egomotion.geom_refine:
            curr_planes = fit_ring_diverse_planes(feat, cfg.odometry)
    dev = feat.xyz.device
    static = None
    if state.have_last:
        with span("ego_motion"):
            rel_q, rel_t, static = _frame_motion(state, scan, feat,
                                                 curr_planes, cfg)
    else:  # no pair yet: everything counts as static for the map gate
        rel_q, rel_t = quat_identity(dev), torch.zeros(3, device=dev)
        if flow_variant:
            static = torch.ones_like(scan["flow_mask"])

    # seg-gate the keyframe cloud with the residual-trimmed static mask:
    # features near the movers advected into the current frame are not
    # stored (odometry is unaffected)
    kf_mask = feat.mask
    n_dyn_over = torch.zeros((), dtype=torch.int64, device=dev)
    if flow_variant and cfg.mapping.seg_gate_keyframes:
        with span("seg_gate"):
            warped = scan["flow_points"] + scan["flow"]
            static_trim = trim_static_mask(scan["flow_points"], scan["flow"],
                                           static, rel_q, rel_t,
                                           cfg.egomotion.refine_trim_resid)
            dyn = scan["flow_mask"] & ~static_trim
            kf_mask = feat.mask & ~near_dynamic(feat.xyz, warped, dyn,
                                                cfg.mapping.seg_gate_radius)
            n_dyn_over = torch.clamp(dyn.long().sum() - DYN_BUDGET, min=0)

    # integrate, renormalised against norm drift
    odom_q, odom_t = pose_compose((state.odom_q, state.odom_t),
                                  (rel_q, rel_t))
    odom_q = quat_normalize(odom_q)
    with span("mapping"):
        map_state, map_out = mapping_step(state.map_state, odom_q, odom_t,
                                          feat.xyz, kf_mask, scan["time"],
                                          cfg.mapping,
                                          cloud_planes=curr_planes)

    last_feat, last_planes = feat, state.last_planes
    if not flow_variant:
        # slide the local map by one cloud, into the current frame
        f = cfg.features.max_features
        old = state.last_feat
        old_xyz = quat_rotate(quat_conjugate(rel_q)[None],
                              old.xyz - rel_t[None])
        last_feat = FeatureCloud(
            xyz=torch.cat([old_xyz[f:], feat.xyz]),
            ring=torch.cat([old.ring[f:], feat.ring]),
            mask=torch.cat([old.mask[f:], feat.mask]))
        with span("features"):
            last_planes = fit_ring_diverse_planes(last_feat, cfg.odometry)
    new_state = SlamState(last_feat=last_feat, last_planes=last_planes,
                          have_last=True, odom_q=odom_q, odom_t=odom_t,
                          vel_q=rel_q, vel_t=rel_t, map_state=map_state)
    outputs = dict(pose_q=map_out["pose_q"], pose_t=map_out["pose_t"],
                   odom_q=odom_q, odom_t=odom_t, rel_q=rel_q, rel_t=rel_t,
                   is_keyframe=map_out["is_keyframe"],
                   n_features=feat.mask.long().sum(), n_dyn_over=n_dyn_over)
    return new_state, outputs


def stack_outputs(outs: list[dict]) -> dict:
    """Per-scan outputs -> numpy arrays over frames: float32 poses (and
    flow), bool ``is_keyframe``, int32 counts; one device-to-host copy per
    key."""
    res = {}
    for key in outs[0]:
        if key == "is_keyframe":
            res[key] = np.asarray([o[key] for o in outs], bool)
            continue
        arr = torch.stack([o[key] for o in outs])
        if arr.dtype == torch.int64:
            arr = arr.to(torch.int32)
        elif arr.is_floating_point():
            arr = arr.float()
        res[key] = arr.cpu().numpy()
    return res


def stack_scans(frames: list, cfg: PipelineConfig,
                flow_key: Optional[str] = None) -> dict:
    """Frame dicts -> stacked numpy scans with the variant's keys: the
    flow variants' frame k carries pair (k-1)'s flow data (row 0 zeros),
    ``flow_key`` naming the flow ("gt" by default); SEG adds the frames'
    ``s_fg_mask`` as ``fg_mask``, SSF their bool ``static_mask``."""
    n = cfg.lidar.max_points

    def shifted(key, dtype=np.float32):
        arr = np.stack([frames[max(k - 1, 0)][key][:n]
                        for k in range(len(frames))])
        arr[0] = 0
        return arr.astype(dtype)

    out = dict(
        points=np.stack([f["pos1"][:n] for f in frames]).astype(np.float32),
        mask=np.stack([f["mask1"][:n].astype(bool) for f in frames]),
        time=np.asarray([f["time"] for f in frames], np.float32))
    if cfg.variant != Variant.ONLY_PC:
        out.update(flow_points=shifted("pos1"),
                   flow_mask=shifted("mask1", bool),
                   flow=shifted(flow_key or "gt"))
    if cfg.variant == Variant.SEG:
        out["fg_mask"] = shifted("s_fg_mask")
    if cfg.variant == Variant.SSF:
        out["static_mask"] = shifted("static_mask", bool)
    return out


def run_sequence_scan(state: SlamState, scans: dict, cfg: PipelineConfig):
    """``slam_step`` over stacked scans (tensors with a leading frame
    axis, as ``stack_scans`` gives them) from ``state``: (final state,
    per-frame outputs as numpy)."""
    outs = []
    with torch.inference_mode():
        for k in range(len(scans["points"])):
            state, o = slam_step(state, {key: v[k] for key, v in
                                         scans.items()}, cfg)
            outs.append(o)
    return state, stack_outputs(outs)


def run_sequence(frames: list, cfg: PipelineConfig,
                 flow_key: Optional[str] = None,
                 device: str | torch.device = "cuda"):
    """Frames (with the variant's provided flow and mask) -> (final
    state, per-frame outputs as numpy)."""
    dev = resolve_device(device)
    set_geom_precision()
    scans = {k: torch.as_tensor(v, device=dev)
             for k, v in stack_scans(frames, cfg, flow_key).items()}
    return run_sequence_scan(init_slam_state(cfg, dev), scans, cfg)
