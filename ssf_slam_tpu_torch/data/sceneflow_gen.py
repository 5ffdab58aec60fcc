"""Ground-truth scene flow from poses and object tracks, a copy of
ssf_slam_tpu/data/sceneflow_gen.py (plain numpy; the port keeps its own copy
and imports nothing of the JAX package).

Given two sensor poses and per-object rigid motions with bounding boxes,
compute per-point GT flow from frame-1 sensor coordinates into frame-2
sensor coordinates: the rigid ego warp everywhere, overridden inside each
dynamic object's box by the object's own motion.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class ObjectTrack:
    """One dynamic object across the frame pair (world-frame)."""

    center1: np.ndarray  # [3] box center at t1
    size: np.ndarray  # [3] full extents
    yaw1: float  # box yaw at t1
    center2: np.ndarray  # [3] at t2
    yaw2: float


def _yaw_mat(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def ego_flow(
    pts1: np.ndarray,
    r1: np.ndarray, t1: np.ndarray,
    r2: np.ndarray, t2: np.ndarray,
) -> np.ndarray:
    """Rigid ego warp frame1 -> frame2 sensor coords minus identity.

    Generate_Sceneflow.py:432-436 computes (row-vector convention)
    arr_ = (arr @ Rsrc^-T + tsrc - ttgt) @ Rtgt^T; equivalently
    R2^T (R1 p + t1 - t2) - p.
    """
    pw = pts1 @ r1.T + t1
    return (pw - t2) @ r2 - pts1


def points_in_box(pts_world: np.ndarray, obj: ObjectTrack) -> np.ndarray:
    """Boolean mask of world points inside the (yawed) box at t1."""
    local = (pts_world - obj.center1) @ _yaw_mat(obj.yaw1)
    return np.all(np.abs(local) <= obj.size / 2 + 1e-6, axis=1)


def compute_pairwise_scene_flow(
    pts1: np.ndarray,
    r1: np.ndarray, t1: np.ndarray,
    r2: np.ndarray, t2: np.ndarray,
    objects: list | None = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (gt_flow [N,3], ego_flow [N,3], fg_mask [N]).

    Flow maps frame-1 sensor coords into frame-2 sensor coords; points inside
    a moving object's box additionally carry the object's own displacement +
    rotation delta (:498-523).
    """
    ego = ego_flow(pts1, r1, t1, r2, t2).astype(np.float32)
    gt = ego.copy()
    fg = np.zeros(len(pts1), np.float32)
    pw = pts1 @ r1.T + t1
    for obj in objects or []:
        inside = points_in_box(pw, obj)
        if not inside.any():
            continue
        # object-local coordinates at t1, re-posed at t2 (rotation delta
        # about the box center + translation)
        local = (pw[inside] - obj.center1) @ _yaw_mat(obj.yaw1)
        moved_w = local @ _yaw_mat(obj.yaw2).T + obj.center2
        gt[inside] = ((moved_w - t2) @ r2 - pts1[inside]).astype(np.float32)
        fg[inside] = 1.0
    return gt, ego, fg


def coarse_bev_flow(
    pts1: np.ndarray,
    pts2: np.ndarray,
    cell: float = 1.0,
    extent: float = 48.0,
    search: int = 4,
) -> np.ndarray:
    """Coarse per-cell planar flow prior by local BEV patch matching.

    Replaces calc_coarse_flow.py (BEV-projection coarse flow prior): both
    clouds are rasterized to occupancy grids; each occupied cell of frame 1
    is matched to the best-correlating shifted cell neighborhood in frame 2;
    returns a per-point [N,3] coarse flow (z = 0).
    """
    n_bins = int(2 * extent / cell)

    def grid(p):
        ij = np.floor((p[:, :2] + extent) / cell).astype(int)
        ok = np.all((ij >= 0) & (ij < n_bins), axis=1)
        g = np.zeros((n_bins, n_bins), np.float32)
        np.add.at(g, (ij[ok, 0], ij[ok, 1]), 1.0)
        return np.minimum(g, 3.0), ij, ok

    g1, ij1, ok1 = grid(pts1)
    g2, _, _ = grid(pts2)

    # local patch correlation per shift
    shifts = [(dx, dy) for dx in range(-search, search + 1)
              for dy in range(-search, search + 1)]
    best = np.zeros((n_bins, n_bins), np.float32) - 1
    fx = np.zeros((n_bins, n_bins), np.float32)
    fy = np.zeros((n_bins, n_bins), np.float32)
    for dx, dy in shifts:
        rolled = np.roll(np.roll(g2, -dx, axis=0), -dy, axis=1)
        score = g1 * rolled
        # smooth 3x3 to compare neighborhoods, not single cells
        score = (
            score
            + np.roll(score, 1, 0) + np.roll(score, -1, 0)
            + np.roll(score, 1, 1) + np.roll(score, -1, 1)
        )
        upd = score > best
        best = np.where(upd, score, best)
        fx = np.where(upd, dx * cell, fx)
        fy = np.where(upd, dy * cell, fy)

    flow = np.zeros((len(pts1), 3), np.float32)
    flow[ok1, 0] = fx[ij1[ok1, 0], ij1[ok1, 1]]
    flow[ok1, 1] = fy[ij1[ok1, 0], ij1[ok1, 1]]
    return flow
