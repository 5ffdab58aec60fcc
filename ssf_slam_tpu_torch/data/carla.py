"""CARLA scene-flow npz frames: the port's copy of
``ssf_slam_tpu/data/carla.py`` (numpy only; a test holds it to the
original on the same files).

Per-frame-pair npz files {pos1, pos2, gt, ego_flow, s_fg_mask, t_fg_mask}
under a directory tree, with utils/datasets/carla.py's preprocessing
options: ground removal at z < -3.3, the GT-mask mover pre-filter, random
subsampling (or padding with a validity mask) to n_points, foreground
oversampling (``hybrid_sample``) and batch collation by stacking;
``compute_label_weights`` gives the segmentation loss's class weights and
``save_sequence_npz`` writes generated frames in this layout.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, Optional

import numpy as np


def load_npz_frame(path: str) -> dict:
    """Load one frame-pair npz into the canonical dict schema."""
    with np.load(path) as z:
        out = {k: np.asarray(z[k]) for k in z.files}
    return out


def pad_points(
    pts: np.ndarray, n: int, rng: Optional[np.random.Generator] = None
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Subsample-or-pad to exactly n rows.

    Returns (points [n, 3], mask [n], index [n] into the original array —
    index is needed to subsample flow/labels consistently).
    """
    m = len(pts)
    if m >= n:
        if rng is None:
            idx = np.arange(n)
        else:
            # sorted: downstream curvature windows (frontend/features.py)
            # assume row-major arrival order is preserved under subsampling
            idx = np.sort(rng.choice(m, n, replace=False))
        return pts[idx].astype(np.float32), np.ones(n, bool), idx
    idx = np.concatenate([np.arange(m), np.zeros(n - m, np.int64)])
    out = pts[idx].astype(np.float32)
    mask = np.zeros(n, bool)
    mask[:m] = True
    return out, mask, idx


def hybrid_sample(
    fg_mask: np.ndarray,  # [M] bool/0-1 moving-point labels
    n: int,
    num_fg: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Foreground-oversampled subsampling (hybrid_sample_points,
    utils/datasets/carla.py:179-200).

    Picks ``num_fg`` moving points (ALL of them when fewer exist, background
    filling the remainder) plus background for the rest — the training-
    balance lever for scenes where movers are a small minority. Returns n
    SORTED indices into the original array (sorted, unlike the reference's
    hstack order, so downstream per-ring curvature windows stay meaningful).
    Requires n <= len(fg_mask).
    """
    fg = np.flatnonzero(fg_mask > 0.5)
    bg = np.flatnonzero(fg_mask <= 0.5)
    n_fg = min(num_fg, len(fg))
    sel_fg = fg if n_fg == len(fg) else rng.choice(fg, n_fg, replace=False)
    n_bg = n - n_fg
    # replacement fallback when a class can't fill its share — the
    # reference's loader resamples with replacement in the same situation
    # (carla.py:274-285); mover-heavy frames can leave a tiny background
    if n_bg == 0:
        sel_bg = np.zeros(0, np.int64)
    elif len(bg) == 0:  # all-mover frame: fall back to foreground
        sel_bg = rng.choice(fg, n_bg, replace=True)
    else:
        sel_bg = rng.choice(bg, n_bg, replace=len(bg) < n_bg)
    return np.sort(np.concatenate([sel_fg, sel_bg]))


class CarlaSceneFlowDataset:
    """Directory-of-npz dataset with CARLA3D-compatible preprocessing."""

    GROUND_Z = -3.3  # carla.py:236 ground-removal threshold

    def __init__(
        self,
        root: str,
        n_points: int = 8192,
        remove_ground: bool = False,
        filter_movers: bool = False,
        fg_points: Optional[int] = None,  # hybrid FG/BG sampling target
        seed: int = 0,
    ):
        self.paths = sorted(
            glob.glob(os.path.join(root, "**", "*.npz"), recursive=True)
        )
        if not self.paths:
            raise FileNotFoundError(f"no npz frames under {root}")
        self.n_points = n_points
        self.remove_ground = remove_ground
        self.filter_movers = filter_movers
        self.fg_points = fg_points
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.paths)

    def _prep(self, frame: dict) -> dict:
        pos1, pos2 = frame["pos1"], frame["pos2"]
        gt = frame.get("gt", np.zeros_like(pos1))
        ego = frame.get("ego_flow", np.zeros_like(pos1))
        fg1 = frame.get("s_fg_mask", np.zeros(len(pos1), np.float32))
        fg2 = frame.get("t_fg_mask", np.zeros(len(pos2), np.float32))
        keep1 = np.ones(len(pos1), bool)
        keep2 = np.ones(len(pos2), bool)
        if "mask1" in frame:
            keep1 &= frame["mask1"].astype(bool)
        if "mask2" in frame:
            keep2 &= frame["mask2"].astype(bool)
        if self.remove_ground:
            keep1 &= pos1[:, 2] > self.GROUND_Z
            keep2 &= pos2[:, 2] > self.GROUND_Z
        if self.filter_movers:
            keep1 &= fg1 < 0.5
            keep2 &= fg2 < 0.5

        n = self.n_points
        if (self.fg_points is not None and not self.filter_movers
                and np.sum(keep1) >= n):
            i1 = hybrid_sample(fg1[keep1], n, self.fg_points, self.rng)
            p1 = pos1[keep1][i1].astype(np.float32)
            m1 = np.ones(n, bool)
        else:
            p1, m1, i1 = pad_points(pos1[keep1], n, self.rng)
        p2, m2, _ = pad_points(pos2[keep2], n, self.rng)
        return dict(
            pos1=p1,
            pos2=p2,
            gt=gt[keep1][i1].astype(np.float32),
            ego_flow=ego[keep1][i1].astype(np.float32),
            s_fg_mask=fg1[keep1][i1].astype(np.float32) * m1,
            t_fg_mask=np.zeros(n, np.float32),
            mask1=m1,
            mask2=m2,
            time=float(frame.get("time", 0.0)),
        )

    def __getitem__(self, i: int) -> dict:
        return self._prep(load_npz_frame(self.paths[i]))

    def batches(self, batch_size: int, shuffle: bool = True) -> Iterator[dict]:
        """Stacked minibatches (Batch-collate equivalent, carla.py:13-76)."""
        order = np.arange(len(self))
        if shuffle:
            self.rng.shuffle(order)
        for s in range(0, len(order) - batch_size + 1, batch_size):
            items = [self[int(i)] for i in order[s : s + batch_size]]
            yield {
                k: np.stack([it[k] for it in items])
                for k in items[0]
                if k != "time"
            }


def compute_label_weights(dataset, n_classes: int = 2,
                          max_items: int | None = None) -> np.ndarray:
    """Inverse-frequency class weights for segmentation training.

    Replaces utils/datasets/my_carla.py:379-393 (labelweights): histogram the
    static/moving labels over the dataset, normalize, and take
    (1/freq)^(1/3) as per-class loss weights.
    """
    counts = np.zeros(n_classes, np.float64)
    n = len(dataset) if max_items is None else min(max_items, len(dataset))
    for i in range(n):
        item = dataset[i]
        labels = (item["s_fg_mask"] > 0.5).astype(int)
        m = item["mask1"].astype(bool)
        counts += np.bincount(labels[m], minlength=n_classes)
    freq = counts / max(counts.sum(), 1.0)
    weights = np.power(np.maximum(freq, 1e-6), -1.0 / 3.0)
    return (weights / weights.sum() * n_classes).astype(np.float32)


def save_sequence_npz(frames: list, out_dir: str) -> list:
    """Write generated frames (data/synthetic.py schema) as npz files."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for k, f in enumerate(frames):
        path = os.path.join(out_dir, f"{k:06d}.npz")
        np.savez_compressed(
            path,
            pos1=f["pos1"], pos2=f["pos2"], gt=f["gt"], ego_flow=f["ego_flow"],
            s_fg_mask=f["s_fg_mask"], t_fg_mask=f["t_fg_mask"],
            mask1=f["mask1"], mask2=f["mask2"], time=f["time"],
        )
        paths.append(path)
    return paths
