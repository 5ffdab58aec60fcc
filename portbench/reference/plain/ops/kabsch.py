"""Weighted Kabsch rigid alignment (ssf_slam_tpu/ops/kabsch.py), float32
with the reflection fix. The 3x3 SVD runs through ``torch.linalg.svd``."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def kabsch(src: Tensor, dst: Tensor,
           weights: Tensor | None = None) -> tuple[Tensor, Tensor]:
    """Rigid fit dst ~= R @ src + t over [..., N, 3] correspondences with
    optional [..., N] nonnegative weights. Returns (R [..., 3, 3], t [..., 3])."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=src.dtype,
                             device=src.device)
    w = weights[..., None]
    wsum = torch.clamp(torch.sum(w, dim=-2, keepdim=True), min=1e-12)
    src_mean = torch.sum(src * w, dim=-2, keepdim=True) / wsum
    dst_mean = torch.sum(dst * w, dim=-2, keepdim=True) / wsum
    src_c = src - src_mean
    dst_c = dst - dst_mean
    h = torch.matmul((src_c * w).transpose(-1, -2), dst_c)  # [..., 3, 3]
    u, _, vt = torch.linalg.svd(h)
    v, ut = vt.transpose(-1, -2), u.transpose(-1, -2)
    det = torch.linalg.det(torch.matmul(v, ut))
    # reflection fix: flip the smallest singular direction
    ones = torch.ones_like(det)
    d = torch.stack([ones, ones, det], dim=-1)
    r = torch.matmul(v * d[..., None, :], ut)
    t = dst_mean[..., 0, :] - torch.matmul(r, src_mean[..., 0, :, None])[..., 0]
    return r, t
