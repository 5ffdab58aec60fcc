"""Planar feature extraction (ssf_slam_tpu/frontend/features.py; the
frameFeature node, src/frameFeature.cpp).

Per padded scan: elevation-angle row assignment, the occlusion-aware
11-point curvature along each row (computed over a stable (row, arrival)
sort with masked shifts), curvature-gated planar candidates thinned to every
``span``-th per row, an optional voxel filter, then compaction to a fixed
feature budget (selected rows first, each group in arrival order).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ssf_slam_tpu_torch.config import FeatureConfig, LidarConfig
from ssf_slam_tpu_torch.ops.voxel import voxel_downsample

Tensor = torch.Tensor


class FeatureCloud(NamedTuple):
    """Fixed-size padded planar-feature cloud."""

    xyz: Tensor  # [F, 3]
    ring: Tensor  # [F] int32 scan row id
    mask: Tensor  # [F] bool validity


def assign_scan_rows(points: Tensor, lidar: LidarConfig) -> Tensor:
    """[N] int32 row ids by elevation angle; -1 outside the vertical FOV."""
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    angle = torch.atan2(z, torch.sqrt(x * x + y * y)) * (180.0 / math.pi)
    if lidar.n_scan_rows == 16:
        row = torch.floor((angle + 15.0) / 2.0 + 0.5).to(torch.int32)
    elif lidar.n_scan_rows == 64:
        upper = torch.floor((2.0 - angle) * 3.0 + 0.5).to(torch.int32)
        lower = lidar.n_scan_rows // 2 + torch.floor(
            (-8.83 - angle) * 2.0 + 0.5).to(torch.int32)
        row = torch.where(angle >= -8.83, upper, lower)
    else:
        lo, hi = lidar.vertical_fov_deg
        pitch = (hi - lo) / max(lidar.n_scan_rows - 1, 1)
        row = torch.floor((angle - lo) / pitch + 0.5).to(torch.int32)
    valid = (row >= 0) & (row < lidar.n_scan_rows)
    return torch.where(valid, row, -1)


def _norm3(v: Tensor) -> Tensor:
    return torch.sqrt((v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])
                      + v[..., 2] * v[..., 2])


def _row_sorted_curvature(xyz: Tensor, row: Tensor, mask: Tensor,
                          halfwin: int) -> Tensor:
    """Curvature per point: the second-difference energy over same-surface
    window neighbours of its row (a range jump of more than 0.3 m + 10 % of
    the range ends a surface), rescaled to the full window; +inf where fewer
    than ``halfwin`` neighbours qualify."""
    n = xyz.shape[0]
    key = torch.where(mask, row, torch.full_like(row, 1 << 20))
    order = torch.sort(key, stable=True).indices
    inv_order = torch.empty_like(order)
    inv_order[order] = torch.arange(n, device=xyz.device)
    sx, srow = xyz[order], key[order]
    srange = _norm3(sx)
    acc = torch.zeros_like(sx)
    count = torch.zeros(n, dtype=torch.float32, device=xyz.device)
    for d in range(1, halfwin + 1):
        for sgn in (-1, 1):
            sh = torch.roll(sx, -sgn * d, dims=0)
            shrow = torch.roll(srow, -sgn * d, dims=0)
            shrange = torch.roll(srange, -sgn * d, dims=0)
            same = (shrow == srow) & (
                torch.abs(shrange - srange) < 0.3 + 0.1 * srange)
            w = same.to(sx.dtype)
            acc = acc + (sh - sx) * w[:, None]
            count = count + w
    scale = 2 * halfwin / torch.clamp(count, min=1.0)
    e = acc * acc
    curv = ((e[:, 0] + e[:, 1]) + e[:, 2]) * scale * scale
    curv = torch.where(count >= halfwin, curv,
                       torch.full_like(curv, math.inf))
    return curv[inv_order]


def _strided_candidate_select(cand: Tensor, row: Tensor, mask: Tensor,
                              span: int) -> Tensor:
    """Every ``span``-th candidate of each row, counted in arrival order."""
    c = (cand & mask).to(torch.int32)
    # [64, N] one-hot rows (a comparison: F.one_hot checks its range on the
    # host), scanned along the contiguous point axis
    rows = torch.arange(64, dtype=row.dtype, device=row.device)
    onehot = (torch.clamp(row, 0, 63)[None, :] == rows[:, None]).to(
        torch.int32)
    hit = onehot * c[None, :]
    ranks = torch.cumsum(hit, dim=1) - hit
    rank = torch.sum(ranks * onehot, dim=0)
    return cand & mask & (rank % span == 0)


def compact_features(xyz: Tensor, ring: Tensor, selected: Tensor,
                     max_features: int) -> FeatureCloud:
    """Selected rows first, then the rest, each in arrival order, cut or
    padded to ``max_features`` rows. The JAX package's ``top_k`` over the
    distinct scores ``n - j`` (selected) / ``-j`` is this stable sort."""
    n = xyz.shape[0]
    j = torch.arange(n, device=xyz.device)
    score = torch.where(selected, n - j, -j)
    k = min(max_features, n)
    idx = torch.sort(score, descending=True, stable=True).indices[:k]
    out = FeatureCloud(xyz=xyz[idx], ring=ring[idx], mask=selected[idx])
    if k < max_features:
        pad = max_features - k
        out = FeatureCloud(
            xyz=torch.cat([out.xyz, xyz.new_zeros(pad, 3)]),
            ring=torch.cat([out.ring, ring.new_zeros(pad)]),
            mask=torch.cat([out.mask, selected.new_zeros(pad)]))
    return out


def extract_plane_features(points: Tensor, mask: Tensor,
                           lidar: LidarConfig = LidarConfig(),
                           cfg: FeatureConfig = FeatureConfig(),
                           apply_voxel: bool = False) -> FeatureCloud:
    """points [N, 3], mask [N] bool -> FeatureCloud of cfg.max_features
    rows. ``apply_voxel`` runs the 0.2 m voxel filter the reference computes
    but does not publish (off, as there)."""
    row = assign_scan_rows(points, lidar)
    mask = mask & (row >= 0)
    if lidar.n_scan_rows == 64:
        mask = mask & (row >= cfg.row_margin_64) & (
            row < lidar.n_scan_rows - cfg.row_margin_64)
    curv = _row_sorted_curvature(points, row, mask, cfg.curvature_halfwin)
    sixteen = lidar.n_scan_rows == 16
    plane_min = cfg.plane_curv_max_16 if sixteen else cfg.plane_curv_max_64
    span = cfg.plane_stride_16 if sixteen else cfg.plane_stride_64
    selected = _strided_candidate_select(curv < plane_min, row, mask, span)
    if apply_voxel:
        points, selected = voxel_downsample(points, cfg.voxel_leaf, selected)
    return compact_features(points, row, selected, cfg.max_features)
