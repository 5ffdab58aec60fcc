"""Keyframe pose-graph mapping back end (ssf_slam_tpu/mapping/keyframes.py;
the mapOptmization node, src/mapOptmization.cpp).

Per odometry frame: the loop-corrected map pose, the keyframe motion gate,
and on a keyframe: scan-to-submap refinement of the new keyframe against
the recent keyframes' stored normals, the keyframe record, loop detection
by radius and time gap, ICP against the candidate's submap, and a batch
pose-graph solve when the loop is accepted.

The JAX package's ``lax.cond`` branches are Python branches here. The
keyframe gate, the loop detection and the loop acceptance each read one
0-d tensor on the host (a sync) when they are reached; the cursors
(``n_kf``, ``n_loops``, ``loop_record_index``) are host integers, so the
other gates cost nothing. Buffers keep the JAX package's preallocated
shapes, but clouds are stored ``[K, F, 3]``: the transposed ``[K, 3, F]``
layout was a TPU lane-padding workaround, and the one-hot ``row_write``
becomes index assignment into the state's own buffers (the step consumes
its input state).

Past ``max_keyframes`` the step keeps the JAX package's semantics: the
cursor keeps counting, a keyframe write past the last row is dropped (the
one-hot select matches no row) and a read past it takes the last row (XLA
clamps gather indices), so the map stops growing instead of failing.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ssf_slam_tpu_torch.config import MappingConfig
from ssf_slam_tpu_torch.device import resolve_device
from ssf_slam_tpu_torch.mapping.posegraph import solve_pose_graph
from ssf_slam_tpu_torch.odometry.scan2map import fit_local_planes
from ssf_slam_tpu_torch.odometry.scan2scan import huber_weight
from ssf_slam_tpu_torch.ops.icp import icp_point_to_point
from ssf_slam_tpu_torch.ops.knn import knn, nearest_neighbor
from ssf_slam_tpu_torch.ops.se3 import (
    cross3,
    matrix_to_quat,
    pose_between,
    pose_compose,
    pose_inverse,
    quat_conjugate,
    quat_identity,
    quat_multiply,
    quat_normalize,
    quat_rotate,
    quat_to_rpy,
    so3_exp_quat,
    so3_log_quat,
)

Tensor = torch.Tensor

# loop-factor slots; once full, a stronger new factor replaces the weakest
MAX_LOOPS = 32


class MapState(NamedTuple):
    """All mapping state, preallocated. K keyframes, F cloud rows, R =
    F // refine_stride strided rows, L loop slots."""

    kf_q: Tensor  # [K, 4] optimised keyframe rotations
    kf_t: Tensor  # [K, 3] optimised keyframe positions
    kf_time: Tensor  # [K]
    kf_cloud: Tensor  # [K, F, 3] feature cloud per keyframe (sensor frame)
    kf_cloud_mask: Tensor  # [K, F]
    kf_rnorm: Tensor  # [K, R, 3] stored normals of the strided rows
    kf_rvalid: Tensor  # [K, R]
    odom_rel_q: Tensor  # [K, 4] measured between factor (i-1 -> i)
    odom_rel_t: Tensor  # [K, 3]
    n_kf: int
    loop_a: Tensor  # [L] int64
    loop_b: Tensor  # [L] int64
    loop_rel_q: Tensor  # [L, 4]
    loop_rel_t: Tensor  # [L, 3]
    loop_w: Tensor  # [L] factor weight (0 = unused slot)
    n_loops: int  # occupied slots (saturates at L)
    n_loops_total: int  # every accepted closure
    loop_record_index: int  # next keyframe index allowed to detect
    adjust_q: Tensor  # [4] accumulated correction (trans_loop_adjust)
    adjust_t: Tensor  # [3]
    cur_q: Tensor  # [4] current map pose
    cur_t: Tensor  # [3]


def init_map_state(max_keyframes: int, cloud_size: int,
                   refine_stride: int = 4,
                   device: str | torch.device = "cuda") -> MapState:
    device = resolve_device(device)
    k, f, l = max_keyframes, cloud_size, MAX_LOOPS
    r = max(cloud_size // max(refine_stride, 1), 1)
    qid = quat_identity(device)

    def zeros(*shape, dt=torch.float32):
        return torch.zeros(*shape, dtype=dt, device=device)

    return MapState(
        kf_q=qid.repeat(k, 1), kf_t=zeros(k, 3), kf_time=zeros(k),
        kf_cloud=zeros(k, f, 3), kf_cloud_mask=zeros(k, f, dt=torch.bool),
        kf_rnorm=zeros(k, r, 3), kf_rvalid=zeros(k, r, dt=torch.bool),
        odom_rel_q=qid.repeat(k, 1), odom_rel_t=zeros(k, 3), n_kf=0,
        loop_a=zeros(l, dt=torch.int64), loop_b=zeros(l, dt=torch.int64),
        loop_rel_q=qid.repeat(l, 1), loop_rel_t=zeros(l, 3),
        loop_w=zeros(l), n_loops=0, n_loops_total=0, loop_record_index=0,
        adjust_q=qid, adjust_t=zeros(3), cur_q=qid, cur_t=zeros(3))


def _norm(v: Tensor) -> Tensor:
    return torch.linalg.norm(v, dim=-1)


def _row(state: MapState, idx: int) -> int:
    """The buffer row a read of keyframe ``idx`` sees: the last row once
    the cursor has run past the buffer, as XLA clamps gather indices."""
    return min(idx, state.kf_q.shape[0] - 1)


def _is_keyframe(state: MapState, q, t, cfg: MappingConfig) -> bool:
    """Motion gate vs the previous keyframe (mapOptmization.cpp:128-144).
    One host sync unless the map is empty."""
    if state.n_kf == 0:
        return True
    last = _row(state, state.n_kf - 1)
    rel_q, rel_t = pose_between((state.kf_q[last], state.kf_t[last]), (q, t))
    roll, pitch, yaw = quat_to_rpy(rel_q)
    g = cfg.keyframe_rot_gate
    small = ((torch.abs(roll) < g) & (torch.abs(pitch) < g)
             & (torch.abs(yaw) < g) & (_norm(rel_t) < cfg.keyframe_trans_gate))
    return not bool(small)


def _detect_loop(state: MapState, idx: int, t: Tensor, cfg: MappingConfig):
    """Nearest earlier keyframe within the search radius and past the time
    gap: (found, candidate) as host values (one sync)."""
    k = state.kf_t.shape[0]
    j = torch.arange(k, device=t.device)
    dist = _norm(state.kf_t - t[None])
    tgap = torch.abs(state.kf_time - state.kf_time[_row(state, idx)])
    ok = (j < idx) & (dist < cfg.loop_search_radius) \
        & (tgap > cfg.loop_time_gap)
    cand = torch.argmin(torch.where(ok, dist, torch.full_like(dist,
                                                             float("inf"))))
    found, cand = torch.stack([ok.any().long(), cand]).tolist()
    return bool(found), cand


def _window(state: MapState, center: int,
            halfwidth: int) -> slice | Tensor:
    """The existing keyframes of center +- halfwidth, in order: a slice,
    so that gathering them needs no index copy to the device, or, once the
    window reaches past the buffer, the rows ``_row`` reads for them."""
    lo = max(center - halfwidth, 0)
    hi = max(min(center + halfwidth + 1, state.n_kf), lo)
    k = state.kf_q.shape[0]
    if hi <= k:
        return slice(lo, hi)
    return torch.clamp(torch.arange(lo, hi), max=k - 1).to(state.kf_q.device)


def _compact_stride(rows: Tensor, mask: Tensor, n_rows: int,
                    out_points: int) -> tuple[Tensor, Tensor]:
    """The valid rows in order, strided to a fixed budget of
    min(out_points, n_rows) (``n_rows``: the size of the whole window,
    existing keyframes or not); without a host sync."""
    n = rows.shape[0]
    maskl = mask.long()
    n_v = maskl.sum()
    slot = torch.cumsum(maskl, 0) - 1
    dst = torch.where(mask, slot, n)
    compact = rows.new_zeros(n + 1, rows.shape[1]).index_copy_(
        0, dst, rows)  # invalid rows all land in the dropped row n
    m = min(out_points, n_rows)
    i = torch.arange(m, device=rows.device)
    sel = torch.where(n_v >= m, (i * n_v) // m, i)
    picked = compact[torch.clamp(sel, max=n)]
    if m > n:  # the window's absent keyframes are zero rows past n
        picked = torch.where((sel < n)[:, None], picked, 0.0)
    return picked, i < n_v


def _build_submap(state: MapState, center: int, halfwidth: int,
                  out_points: int):
    """Keyframe clouds of center +- halfwidth in the map frame, compacted
    and strided to the budget (mapOptmization.cpp:201-223)."""
    ks = _window(state, center, halfwidth)
    f = state.kf_cloud.shape[1]
    clouds, masks = state.kf_cloud[ks], state.kf_cloud_mask[ks]
    qs, ts = state.kf_q[ks], state.kf_t[ks]
    pts = (quat_rotate(qs[:, None, :], clouds) + ts[:, None, :]).reshape(-1, 3)
    return _compact_stride(pts, masks.reshape(-1), (2 * halfwidth + 1) * f,
                           out_points)


def _build_refine_submap(state: MapState, center: int, halfwidth: int,
                         out_points: int):
    """Refine target: the strided rows of center +- halfwidth with their
    stored normals, in the map frame, compacted and strided to the budget.
    Returns (pts [S, 3], nrm [S, 3], mask [S])."""
    _, r, _ = state.kf_rnorm.shape
    stride = max(state.kf_cloud.shape[1] // r, 1)
    ks = _window(state, center, halfwidth)
    clouds = state.kf_cloud[ks, ::stride][:, :r]
    masks = state.kf_cloud_mask[ks, ::stride][:, :r] & state.kf_rvalid[ks]
    qs, ts = state.kf_q[ks][:, None, :], state.kf_t[ks][:, None, :]
    both = torch.cat([quat_rotate(qs, clouds) + ts,
                      quat_rotate(qs, state.kf_rnorm[ks])], -1)
    picked, mask = _compact_stride(both.reshape(-1, 6), masks.reshape(-1),
                                   (2 * halfwidth + 1) * r, out_points)
    return picked[:, :3], picked[:, 3:], mask


def _register_to_submap(src_xyz, src_mask, tgt, tgt_nrm, tgt_mask, q0, t0,
                        cfg: MappingConfig):
    """Point-to-plane GN of the strided source rows against the refine
    submap: one association at the incoming pose, then ``refine_gn_iters``
    Huber-IRLS steps with a prior anchored at (q0, t0) and per-step clamps.
    Returns (q, t, n_inliers)."""
    warped = quat_rotate(q0[None], src_xyz) + t0[None]
    d, j = knn(warped, tgt, 1, points_mask=tgt_mask, approx=True,
               rerank=False)
    j, d = j[:, 0], d[:, 0]
    pa, na = tgt[j], tgt_nrm[j]
    w_valid = src_mask & tgt_mask[j] & (d < cfg.refine_max_corr_dist ** 2)
    n_in = torch.sum(w_valid.to(torch.int32))
    dev, dt = src_xyz.device, src_xyz.dtype
    w_prior = torch.cat([torch.full((3,), cfg.refine_prior_rot, dtype=dt,
                                    device=dev),
                         torch.full((3,), cfg.refine_prior_trans, dtype=dt,
                                    device=dev)])
    damp = torch.diag(w_prior) + 1e-6 * torch.eye(6, dtype=dt, device=dev)
    q, t = q0, t0
    for _ in range(cfg.refine_gn_iters):
        u = quat_rotate(q[None], src_xyz)
        r = torch.sum((u + t[None] - pa) * na, dim=-1)
        w = huber_weight(r, cfg.refine_huber) * w_valid.to(dt)
        jac = torch.cat([cross3(u, na), na], dim=-1)
        h = (jac * w[:, None]).T @ jac + damp
        g = jac.T @ (w * r) + w_prior * torch.cat(
            [so3_log_quat(quat_multiply(q, quat_conjugate(q0))), t - t0])
        delta = -torch.linalg.solve_ex(h, g)[0]  # no sync on the info check
        delta = torch.cat([
            torch.clamp(delta[:3], -cfg.refine_max_rot_step,
                        cfg.refine_max_rot_step),
            torch.clamp(delta[3:], -cfg.refine_max_trans_step,
                        cfg.refine_max_trans_step)])
        q = quat_normalize(quat_multiply(so3_exp_quat(delta[:3]), q))
        t = t + delta[3:]
    return q, t, n_in


def _refine_to_submap(state: MapState, q, t, src_xyz, src_mask,
                      cfg: MappingConfig):
    """Scan-to-map refinement of the incoming keyframe. The acceptance is
    a select, not a branch (no sync). Returns (q_ref, t_ref, corr_q,
    corr_t, accepted)."""
    center = state.n_kf - 1 - cfg.refine_halfwidth
    tgt, tgt_nrm, tgt_mask = _build_refine_submap(
        state, center, cfg.refine_halfwidth, cfg.refine_submap_points)
    q2, t2, n_in = _register_to_submap(src_xyz, src_mask, tgt, tgt_nrm,
                                       tgt_mask, q, t, cfg)
    corr_q, corr_t = pose_compose((q2, t2), pose_inverse((q, t)))
    accept = ((n_in >= cfg.refine_min_inliers)
              & (_norm(corr_t) < cfg.refine_max_trans)
              & (_norm(so3_log_quat(corr_q)) < cfg.refine_max_rot))
    qid = quat_identity(q.device).to(q.dtype)
    return (torch.where(accept, q2, q), torch.where(accept, t2, t),
            torch.where(accept, corr_q, qid),
            torch.where(accept, corr_t, torch.zeros_like(corr_t)), accept)


def _try_close_loop(state: MapState, idx: int,
                    cfg: MappingConfig) -> MapState:
    """ICP the keyframe ``idx`` against its loop candidate's submap; on
    acceptance add a loop factor and solve the pose graph."""
    row = _row(state, idx)
    found, cand = _detect_loop(state, idx, state.kf_t[row], cfg)
    if not found:
        return state
    # the detection attempt consumes the 2-frame skip (:196)
    state = state._replace(
        loop_record_index=idx + cfg.loop_skip_after_detect)
    qi, ti = state.kf_q[row], state.kf_t[row]
    src = quat_rotate(qi[None], state.kf_cloud[row]) + ti[None]
    src_mask = state.kf_cloud_mask[row]
    tgt, tgt_mask = _build_submap(state, cand, cfg.loop_submap_halfwidth,
                                  cfg.submap_points)
    r, t_corr, fitness = icp_point_to_point(
        src, tgt, src_mask, tgt_mask, max_corr_dist=cfg.icp_max_corr_dist,
        iters=cfg.icp_iters)
    d2_pre, _ = nearest_neighbor(src, tgt, points_mask=tgt_mask, approx=True)
    w_pre = (src_mask & (d2_pre < cfg.icp_max_corr_dist ** 2)).to(src.dtype)
    fitness_pre = torch.sum(d2_pre * w_pre) / torch.clamp(torch.sum(w_pre),
                                                           min=1.0)
    accept = (fitness < cfg.icp_fitness_gate) | (
        fitness < cfg.icp_rel_improve * fitness_pre)
    # correction-magnitude gate: a legitimate closure cannot move the pose
    # much beyond the search radius it was detected in
    corr_disp = r @ ti + t_corr - ti
    accept = accept & (_norm(corr_disp) < 1.5 * cfg.loop_search_radius)
    # buffer full: the new factor must beat the weakest stored one
    l_cap = state.loop_w.shape[0]
    w = 1.0 / torch.clamp(fitness, min=1e-6)
    saturated = state.n_loops >= l_cap
    weakest = torch.argmin(state.loop_w)
    if saturated:
        accept = accept & (w > state.loop_w[weakest])
    if not bool(accept):
        return state
    corr = (matrix_to_quat(r), t_corr)
    pose_corrected = pose_compose(corr, (qi, ti))
    rel_q, rel_t = pose_between(pose_corrected,
                                (state.kf_q[cand], state.kf_t[cand]))
    li = weakest if saturated else min(state.n_loops, l_cap - 1)
    adj_q, adj_t = pose_compose(corr, (state.adjust_q, state.adjust_t))
    state.loop_a[li], state.loop_b[li] = idx, cand
    state.loop_rel_q[li], state.loop_rel_t[li] = rel_q, rel_t
    state.loop_w[li] = w
    state = state._replace(
        n_loops=min(state.n_loops + 1, l_cap),
        n_loops_total=state.n_loops_total + 1,
        loop_record_index=state.loop_record_index + cfg.loop_skip_after_close,
        # renormalised: the adjust compounds forever, and an off-unit norm
        # squares per fold
        adjust_q=quat_normalize(adj_q), adjust_t=adj_t)
    active = torch.arange(state.kf_q.shape[0], device=qi.device) < state.n_kf
    new_q, new_t = solve_pose_graph(
        state.kf_q, state.kf_t, active, state.odom_rel_q, state.odom_rel_t,
        state.loop_a, state.loop_b, state.loop_rel_q, state.loop_rel_t,
        state.loop_w, odom_w_rot=1.0 / cfg.odom_rot_var,
        odom_w_trans=1.0 / cfg.odom_trans_var, iters=cfg.posegraph_gn_iters)
    return state._replace(kf_q=new_q, kf_t=new_t)


def _add_keyframe(state: MapState, q, t, cloud_xyz, cloud_mask, time,
                  cfg: MappingConfig, cloud_planes=None) -> MapState:
    idx = state.n_kf
    r = state.kf_rnorm.shape[1]
    stride = max(cloud_xyz.shape[0] // r, 1)
    src_xyz, src_mask = cloud_xyz[::stride][:r], cloud_mask[::stride][:r]
    qk, tk = q, t
    if cfg.scan_to_map_refine:
        if cloud_planes is not None:  # the scan's ring-diverse planes
            src_nrm = cloud_planes.normal[::stride][:r]
            src_nvalid = cloud_planes.valid[::stride][:r]
        else:
            src_nrm, src_nvalid = fit_local_planes(src_xyz, src_mask)
        if idx >= cfg.refine_min_keyframes:
            qk, tk, cq, ct, _ = _refine_to_submap(state, q, t, src_xyz,
                                                  src_mask, cfg)
            # fold into the running adjust so every later pose inherits it;
            # renormalised as in the loop-closure fold
            adj_q, adj_t = pose_compose((cq, ct),
                                        (state.adjust_q, state.adjust_t))
            state = state._replace(adjust_q=quat_normalize(adj_q),
                                   adjust_t=adj_t)
    else:
        src_nrm = torch.zeros_like(src_xyz)
        src_nvalid = torch.zeros_like(src_mask)
    if idx < state.kf_q.shape[0]:
        prev = max(idx - 1, 0)
        rel_q, rel_t = pose_between((state.kf_q[prev], state.kf_t[prev]),
                                    (qk, tk))
        # the buffers are owned by the state: written in place
        state.kf_q[idx], state.kf_t[idx], state.kf_time[idx] = qk, tk, time
        state.kf_cloud[idx], state.kf_cloud_mask[idx] = cloud_xyz, cloud_mask
        state.kf_rnorm[idx] = src_nrm
        state.kf_rvalid[idx] = src_nvalid & src_mask
        state.odom_rel_q[idx], state.odom_rel_t[idx] = rel_q, rel_t
    state = state._replace(n_kf=idx + 1)
    if (cfg.enable_loop_closure and state.n_kf >= cfg.loop_min_keyframes
            and idx > state.loop_record_index):
        state = _try_close_loop(state, idx, cfg)
    row = _row(state, idx)
    return state._replace(cur_q=state.kf_q[row], cur_t=state.kf_t[row])


def mapping_step(state: MapState, odom_q: Tensor, odom_t: Tensor,
                 cloud_xyz: Tensor, cloud_mask: Tensor, time,
                 cfg: MappingConfig = MappingConfig(), cloud_planes=None):
    """One odometry frame + feature cloud [F, 3] / [F] -> (state,
    {pose_q, pose_t, is_keyframe}). The pose is the loop-corrected map pose
    (T_map = trans_loop_adjust * T_odom, :450), or the new keyframe's
    (refined, possibly re-optimised) pose on a keyframe. A keyframe stores
    the strided rows of ``cloud_planes`` (the cloud's ``PlaneModel``, which
    ONLY_PC and ``geom_refine`` fit anyway) as its normals; without them
    the strided rows' normals are fit inside the keyframe branch."""
    q, t = pose_compose((state.adjust_q, state.adjust_t), (odom_q, odom_t))
    is_kf = _is_keyframe(state, q, t, cfg)
    if is_kf:
        state = _add_keyframe(state, q, t, cloud_xyz, cloud_mask, time, cfg,
                              cloud_planes)
    else:
        state = state._replace(cur_q=q, cur_t=t)
    return state, dict(pose_q=state.cur_q, pose_t=state.cur_t,
                       is_keyframe=is_kf)
