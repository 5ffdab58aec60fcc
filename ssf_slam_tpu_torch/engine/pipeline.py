"""The per-scan SLAM step (ssf_slam_tpu/engine/pipeline.py) for the flow
variants with ``geom_refine=False``:

    plane features -> flow ego-motion (static-masked IRLS Kabsch) ->
    odometry integration -> seg-gated keyframe mapping (+ scan-to-map
    refine, loop closure, pose graph)

The JAX package's ``lax.cond`` on the first-frame gate is a host bool here.
This port runs the SSF variant (static mask given with the flow); the other
variants and ``geom_refine`` raise NotImplementedError.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ssf_slam_tpu_torch.config import PipelineConfig, Variant
from ssf_slam_tpu_torch.device import resolve_device
from ssf_slam_tpu_torch.frontend.features import extract_plane_features
from ssf_slam_tpu_torch.mapping.keyframes import (
    MapState,
    init_map_state,
    mapping_step,
)
from ssf_slam_tpu_torch.odometry.egomotion import (
    ego_motion_from_flow,
    trim_static_mask,
)
from ssf_slam_tpu_torch.ops.precision import set_geom_precision
from ssf_slam_tpu_torch.ops.se3 import (
    pose_compose,
    quat_identity,
    quat_normalize,
)

Tensor = torch.Tensor


class SlamState(NamedTuple):
    """Carry of the per-scan step. The JAX package's ``last_feat`` and
    ``vel_q/vel_t`` serve the ONLY_PC scan-to-scan, which is not ported."""

    have_last: bool  # first-frame gate
    odom_q: Tensor  # [4] integrated frame odometry (q_0_curr)
    odom_t: Tensor  # [3]
    map_state: MapState


def check_supported(cfg: PipelineConfig) -> None:
    if cfg.variant != Variant.SSF:
        raise NotImplementedError("the port runs the SSF variant only")
    if cfg.egomotion.geom_refine:
        raise NotImplementedError("geom_refine is not ported")


def init_slam_state(cfg: PipelineConfig,
                    device: str | torch.device = "cuda") -> SlamState:
    check_supported(cfg)
    device = resolve_device(device)
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
    """One scan: {points [N, 3], mask [N], time, flow_points [N, 3],
    flow_mask [N], flow [N, 3], static_mask [N]}, where the flow entries
    are the previous pair's (frame k-1 -> k). Returns (state, outputs) with
    the map pose ``pose_q/pose_t``, the odometry ``odom_q/odom_t``, the
    frame motion ``rel_q/rel_t``, ``is_keyframe`` (host bool),
    ``n_features`` and ``n_dyn_over`` (0-d tensors)."""
    check_supported(cfg)
    feat = extract_plane_features(scan["points"], scan["mask"], cfg.lidar,
                                  cfg.features)
    dev = feat.xyz.device
    ego = cfg.egomotion
    if state.have_last:
        static = scan["static_mask"] & scan["flow_mask"]
        rel_q, rel_t = ego_motion_from_flow(
            scan["flow_points"], scan["flow"], static,
            irls_iters=ego.irls_iters, irls_sigma=ego.irls_sigma)
    else:  # no pair yet: everything counts as static for the map gate
        rel_q, rel_t = quat_identity(dev), torch.zeros(3, device=dev)
        static = torch.ones_like(scan["flow_mask"])

    # seg-gate the keyframe cloud with the residual-trimmed static mask:
    # features near the movers advected into the current frame are not
    # stored (odometry is unaffected)
    kf_mask = feat.mask
    n_dyn_over = torch.zeros((), dtype=torch.int64, device=dev)
    if cfg.mapping.seg_gate_keyframes:
        warped = scan["flow_points"] + scan["flow"]
        static_trim = trim_static_mask(scan["flow_points"], scan["flow"],
                                       static, rel_q, rel_t,
                                       ego.refine_trim_resid)
        dyn = scan["flow_mask"] & ~static_trim
        kf_mask = feat.mask & ~near_dynamic(feat.xyz, warped, dyn,
                                            cfg.mapping.seg_gate_radius)
        n_dyn_over = torch.clamp(dyn.long().sum() - DYN_BUDGET, min=0)

    # integrate, renormalised against norm drift
    odom_q, odom_t = pose_compose((state.odom_q, state.odom_t),
                                  (rel_q, rel_t))
    odom_q = quat_normalize(odom_q)
    map_state, map_out = mapping_step(state.map_state, odom_q, odom_t,
                                      feat.xyz, kf_mask, scan["time"],
                                      cfg.mapping)
    new_state = SlamState(have_last=True, odom_q=odom_q, odom_t=odom_t,
                          map_state=map_state)
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
    """Frame dicts -> stacked numpy scans. Frame k carries pair (k-1)'s
    flow data (row 0 zeros); ``flow_key`` names the flow ("gt" by
    default) and each frame needs a bool ``static_mask``."""
    check_supported(cfg)
    n = cfg.lidar.max_points

    def shifted(key, dtype=np.float32):
        arr = np.stack([frames[max(k - 1, 0)][key][:n]
                        for k in range(len(frames))])
        arr[0] = 0
        return arr.astype(dtype)

    return dict(
        points=np.stack([f["pos1"][:n] for f in frames]).astype(np.float32),
        mask=np.stack([f["mask1"][:n].astype(bool) for f in frames]),
        time=np.asarray([f["time"] for f in frames], np.float32),
        flow_points=shifted("pos1"),
        flow_mask=shifted("mask1", bool),
        flow=shifted(flow_key or "gt"),
        static_mask=shifted("static_mask", bool))


def run_sequence(frames: list, cfg: PipelineConfig,
                 flow_key: Optional[str] = None,
                 device: str | torch.device = "cuda"):
    """Frames with a provided flow and static mask -> (final state,
    per-frame outputs as numpy)."""
    dev = resolve_device(device)
    set_geom_precision()
    scans = {k: torch.as_tensor(v, device=dev)
             for k, v in stack_scans(frames, cfg, flow_key).items()}
    state = init_slam_state(cfg, dev)
    outs = []
    with torch.inference_mode():
        for k in range(len(frames)):
            state, o = slam_step(state, {key: v[k] for key, v in
                                         scans.items()}, cfg)
            outs.append(o)
    return state, stack_outputs(outs)
