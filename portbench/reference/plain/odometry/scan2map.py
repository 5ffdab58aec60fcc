"""Local plane fits on ring-less clouds (ssf_slam_tpu/odometry/scan2map.py).

The keyframe branch of the mapping back end fits the normals of a new
keyframe's strided rows here: a total-least-squares plane per point from
its k-NN neighbourhood, with the same conditioning gates as the JAX
package.
"""

from __future__ import annotations

import torch

from portbench.reference.plain.odometry.scan2scan import PlaneModel
from portbench.reference.plain.ops.eig3 import smallest_eigvec_sym3
from portbench.reference.plain.ops.knn import knn

Tensor = torch.Tensor


def fit_local_planes(pts: Tensor, mask: Tensor, k: int = 8,
                     spread_min: float = 1e-3,
                     thickness_max: float = 0.05) -> PlaneModel:
    """Masked TLS plane per point. Valid where >= 4 neighbours are valid,
    the middle eigenvalue exceeds ``spread_min`` (two spanned directions)
    and the smallest is below ``thickness_max``^2 (flat)."""
    # the candidate pass only: the fit takes the neighbourhood as a set
    _, idx = knn(pts, pts, k, points_mask=mask, approx=True, rerank=False)
    nb = pts[idx]  # [N, k, 3]
    w = mask[idx].to(pts.dtype)  # [N, k]
    wsum = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    mean = torch.sum(nb * w[..., None], dim=1, keepdim=True) / wsum[..., None]
    c = nb - mean
    cov = torch.einsum("nkc,nkd->ncd", c * w[..., None], c) / wsum[..., None]
    evals, normal = smallest_eigvec_sym3(cov)
    valid = (mask & (torch.sum(w, dim=-1) >= 4)
             & (evals[..., 1] > spread_min)
             & (evals[..., 0] < thickness_max ** 2))
    return PlaneModel(normal=normal, valid=valid)
