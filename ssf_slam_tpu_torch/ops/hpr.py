"""Hidden point removal (visibility from a viewpoint): the port's copy of
``ssf_slam_tpu/ops/hpr.py`` (numpy and scipy; tests/test_torch_aux.py
holds it to the original).

The Katz et al. spherical-inversion operator: points are flipped about a
sphere centred at the viewpoint, and the convex hull of the flipped set
holds exactly the visible points. The hull runs on the host
(``scipy.spatial.ConvexHull``). Used by ``data/setcover.py``.
"""

from __future__ import annotations

import numpy as np


def spherical_flip(points: np.ndarray, viewpoint: np.ndarray,
                   radius_scale: float = 100.0) -> np.ndarray:
    """Katz inversion: p' = p + 2 (R - |p|) p / |p| about the viewpoint."""
    p = points - viewpoint[None]
    norm = np.linalg.norm(p, axis=1, keepdims=True)
    radius = radius_scale * norm.max()
    return p + 2.0 * (radius - norm) * p / np.maximum(norm, 1e-12)


def hidden_point_removal(
    points: np.ndarray, viewpoint: np.ndarray, radius_scale: float = 100.0
) -> np.ndarray:
    """Return the boolean visibility mask of ``points`` from ``viewpoint``."""
    from scipy.spatial import ConvexHull

    flipped = spherical_flip(points, viewpoint, radius_scale)
    # the viewpoint (origin after shift) must be part of the hull
    cloud = np.concatenate([flipped, np.zeros((1, 3))], axis=0)
    hull = ConvexHull(cloud)
    visible = np.zeros(len(points), dtype=bool)
    idx = hull.vertices
    visible[idx[idx < len(points)]] = True
    return visible
