"""Voxel-grid downsampling with static shapes (ssf_slam_tpu/ops/voxel.py).

The input's N is kept: a validity mask selects one representative per
occupied voxel (the lowest valid index), whose position becomes the voxel
centroid. Voxels are found by an int32 multiplicative hash into a table of
``table_mult * N`` slots; collisions merge voxels, as in the JAX package.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _voxel_hash(coords: Tensor, table_size: int) -> Tensor:
    """[..., 3] int32 voxel coords -> [...] int64 slot in [0, table_size).

    The products wrap on int32 overflow as XLA's do, ``abs`` of INT_MIN
    stays INT_MIN, and ``%`` is a floor-mod (``jnp.remainder``), so the slot
    is non-negative either way."""
    h = (coords[..., 0] * 73856093) ^ (coords[..., 1] * 19349663) \
        ^ (coords[..., 2] * 83492791)
    return torch.remainder(torch.abs(h), table_size).long()


def voxel_downsample(points: Tensor, leaf: float, mask: Tensor | None = None,
                     table_mult: int = 4) -> tuple[Tensor, Tensor]:
    """points [N, 3], optional mask [N] -> (out_points [N, 3], out_mask [N]):
    out_mask selects one representative per occupied voxel and those rows
    hold the voxel centroid; other rows keep their input position."""
    n = points.shape[0]
    table_size = table_mult * n
    if mask is None:
        mask = torch.ones(n, dtype=torch.bool, device=points.device)
    coords = torch.floor(points / leaf).to(torch.int32)
    slot = _voxel_hash(coords, table_size)
    w = mask.to(points.dtype)
    sums = torch.zeros(table_size, 3, dtype=points.dtype,
                       device=points.device).index_add_(0, slot,
                                                        points * w[:, None])
    cnts = torch.zeros(table_size, dtype=points.dtype,
                       device=points.device).index_add_(0, slot, w)
    idxs = torch.arange(n, dtype=torch.int32, device=points.device)
    min_idx = torch.full((table_size,), n, dtype=torch.int32,
                         device=points.device).scatter_reduce_(
        0, slot, torch.where(mask, idxs, n), reduce="amin")
    is_rep = mask & (min_idx[slot] == idxs)
    centroid = sums[slot] / torch.clamp(cnts[slot], min=1.0)[:, None]
    return torch.where(is_rep[:, None], centroid, points), is_rep
