"""Active-sensing viewpoint selection (set-cover next-best-view): the
port's copy of ``ssf_slam_tpu/data/setcover.py`` (numpy and scipy, on the
port's ``ops/hpr.py``; tests/test_torch_aux.py holds it to the original).

Candidate sensor positions are scored by how many not yet covered scene
voxels they would observe (visibility by hidden point removal), and the
next best view is picked greedily.
"""

from __future__ import annotations

import numpy as np

from ssf_slam_tpu_torch.ops.hpr import hidden_point_removal


def voxel_keys(points: np.ndarray, leaf: float) -> np.ndarray:
    """[N] int64 voxel ids (host-side; for coverage bookkeeping)."""
    c = np.floor(points / leaf).astype(np.int64)
    return (c[:, 0] * 73856093) ^ (c[:, 1] * 19349663) ^ (c[:, 2] * 83492791)


def viewpoint_value(
    points: np.ndarray,
    viewpoint: np.ndarray,
    covered: set,
    leaf: float = 0.5,
    max_range: float = 60.0,
) -> tuple[float, set]:
    """(newly-covered voxel count, their ids) for a candidate viewpoint."""
    d = np.linalg.norm(points - viewpoint[None], axis=1)
    in_range = d < max_range
    if in_range.sum() < 4:
        return 0.0, set()
    pts = points[in_range]
    vis = hidden_point_removal(pts, viewpoint)
    keys = set(voxel_keys(pts[vis], leaf).tolist()) - covered
    return float(len(keys)), keys


class PositionSelector:
    """Greedy next-best-view over a candidate grid (SetCover.py:184-238)."""

    def __init__(self, points: np.ndarray, leaf: float = 0.5,
                 max_range: float = 60.0):
        self.points = points
        self.leaf = leaf
        self.max_range = max_range
        self.covered: set = set()

    def next_best_view(self, candidates: np.ndarray) -> tuple[int, float]:
        """Return (index of best candidate, its new-coverage value) and mark
        its coverage as consumed."""
        best_i, best_v, best_keys = -1, -1.0, set()
        for i, c in enumerate(candidates):
            v, keys = viewpoint_value(
                self.points, np.asarray(c, float), self.covered, self.leaf,
                self.max_range,
            )
            if v > best_v:
                best_i, best_v, best_keys = i, v, keys
        self.covered |= best_keys
        return best_i, best_v
