"""Morton (Z-order) codes, the Morton sort and the windowed kNN
(ssf_slam_tpu/ops/morton.py).

``morton_codes`` is bit-exact with the JAX package: the quantisation
keeps its float32 op order ``clip((xyz - origin) / scale * 1024, 0,
1023)`` and truncates; codes are int64 here (PyTorch's uint32 support is
thin), holding the same 30-bit values. ``morton_argsort`` is the stable sort by code (invalid points
last); ``knn_windowed`` is the approximate kNN over a band of +-W/2
Morton ranks around each query's place among the sorted points (ties to
the lower band slot, as ``jax.lax.top_k``; distances rounded as XLA
rounds the reference's on the CPU).
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def _expand_bits(v: Tensor) -> Tensor:
    """Spread the low 10 bits of v so there are 2 zero bits between each."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def morton_codes(xyz: Tensor, extent: float = 64.0,
                 origin: Tensor | None = None,
                 scale: Tensor | None = None) -> Tensor:
    """[..., N, 3] float32 -> [..., N] int64 Z-order codes (10 bits/axis).

    The quantisation box is [origin, origin + scale] (isotropic); the
    defaults give the fixed [-extent, +extent] box.
    """
    if origin is None:
        origin = -extent
    if scale is None:
        scale = 2 * extent
    q = torch.clamp((xyz - origin) / scale * 1024.0, 0.0, 1023.0)
    q = q.to(torch.int64)
    return (_expand_bits(q[..., 0])
            | (_expand_bits(q[..., 1]) << 1)
            | (_expand_bits(q[..., 2]) << 2))


INVALID_CODE = 0xFFFFFFFF  # the JAX package's uint32 sentinel


def fma32(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """float32 fused multiply-add, round(a * b + c): the float32 product is
    exact in float64, so only the sum rounds (then once more to float32)."""
    return (a.double() * b.double() + c.double()).float()


def morton_argsort(xyz: Tensor, mask: Tensor | None = None,
                   extent: float = 64.0, origin: Tensor | None = None,
                   scale: Tensor | None = None) -> Tensor:
    """[..., N] int64 permutation sorting points by Morton code, stable,
    invalid points (``mask`` False) last."""
    codes = morton_codes(xyz, extent, origin=origin, scale=scale)
    if mask is not None:
        codes = torch.where(mask, codes, torch.full_like(codes, INVALID_CODE))
    return torch.argsort(codes, dim=-1, stable=True)


def knn_windowed(query_sorted: Tensor, points_sorted: Tensor, k: int,
                 window: int = 64, points_mask: Tensor | None = None,
                 extent: float = 64.0) -> tuple[Tensor, Tensor]:
    """Approximate kNN of Morton-sorted queries [N, 3] among Morton-sorted
    points [M, 3] (``morton_argsort``) over a band of ``window`` sorted
    ranks centred on each query's insertion point: (sqdist [N, k], idx
    [N, k] into the sorted points), ascending. Masked points get distance
    1e10."""
    m = points_sorted.shape[0]
    w = min(window, m)
    qcodes = morton_codes(query_sorted, extent)
    pcodes = morton_codes(points_sorted, extent)
    if points_mask is not None:  # morton_argsort's sentinel keeps it sorted
        pcodes = torch.where(points_mask, pcodes,
                             torch.full_like(pcodes, INVALID_CODE))
    center = torch.searchsorted(pcodes, qcodes)
    start = torch.clamp(center - w // 2, 0, m - w)
    band_idx = start[:, None] + torch.arange(w, device=start.device)[None]
    dx, dy, dz = (points_sorted[band_idx] - query_sorted[:, None]).unbind(-1)
    # the reference's sum((band - q)**2) as XLA compiles it on the CPU:
    # fma(dz, dz, fma(dy, dy, dx*dx)), each fma rounded once to float32
    d = fma32(dz, dz, fma32(dy, dy, dx * dx))
    if points_mask is not None:
        d = torch.where(points_mask[band_idx], d, torch.full_like(d, 1e10))
    d_sorted, pos = torch.sort(d, dim=-1, stable=True)
    return d_sorted[:, :k], torch.gather(band_idx, -1, pos[:, :k])
