"""Training-data helpers: the port's numpy copies of
``ssf_slam_tpu/data/carla.py::hybrid_sample`` and
``compute_label_weights`` (the rest of that module, the CARLA npz reader,
is not ported).
"""

from __future__ import annotations

import numpy as np


def hybrid_sample(fg_mask: np.ndarray, n: int, num_fg: int,
                  rng: np.random.Generator) -> np.ndarray:
    """Foreground-oversampled subsampling (hybrid_sample_points,
    utils/datasets/carla.py:179-200): ``num_fg`` moving points (all of them
    when fewer exist) plus background for the rest, with replacement where
    a class cannot fill its share. Returns n SORTED indices into fg_mask
    [M] (n <= M)."""
    fg = np.flatnonzero(fg_mask > 0.5)
    bg = np.flatnonzero(fg_mask <= 0.5)
    n_fg = min(num_fg, len(fg))
    sel_fg = fg if n_fg == len(fg) else rng.choice(fg, n_fg, replace=False)
    n_bg = n - n_fg
    if n_bg == 0:
        sel_bg = np.zeros(0, np.int64)
    elif len(bg) == 0:  # all-mover frame: fall back to foreground
        sel_bg = rng.choice(fg, n_bg, replace=True)
    else:
        sel_bg = rng.choice(bg, n_bg, replace=len(bg) < n_bg)
    return np.sort(np.concatenate([sel_fg, sel_bg]))


def compute_label_weights(dataset, n_classes: int = 2,
                          max_items: int | None = None) -> np.ndarray:
    """Inverse-frequency class weights for the segmentation loss
    (utils/datasets/my_carla.py:379-393, labelweights): the static/moving
    label histogram over the valid points of the first ``max_items`` items,
    normalised, as (1 / freq)^(1/3) scaled to sum to ``n_classes``."""
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
