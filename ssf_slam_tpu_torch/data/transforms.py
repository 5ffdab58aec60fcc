"""Training-time augmentation for scene-flow frame pairs: the port's copy
of ``ssf_slam_tpu/data/transforms.py`` (numpy only;
tests/test_torch_aux.py holds it to the original with the same seed).

A random yaw, uniform scaling, an optional mirror, a translation and
per-point jitter, applied consistently to (pos1, pos2, gt, ego_flow) so
that the flow stays geometrically valid:

    pos1' = A pos1,  pos2' = A pos2  =>  gt' = A (pos1 + gt) - A pos1

It runs on the host, in the input pipeline.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class AugmentConfig:
    rot_z_max: float = np.pi  # uniform yaw
    scale_range: tuple = (0.95, 1.05)
    trans_max: float = 0.5
    jitter_sigma: float = 0.01
    jitter_clip: float = 0.05
    flip_prob: float = 0.5


def augment_pair(frame: dict, rng: np.random.Generator,
                 cfg: AugmentConfig = AugmentConfig()) -> dict:
    """Return an augmented copy of a frame dict (pos1/pos2/gt/ego_flow...)."""
    yaw = rng.uniform(-cfg.rot_z_max, cfg.rot_z_max)
    c, s = np.cos(yaw), np.sin(yaw)
    a = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    scale = rng.uniform(*cfg.scale_range)
    a = a * scale
    if rng.uniform() < cfg.flip_prob:
        a = a @ np.diag([1.0, -1.0, 1.0]).astype(np.float32)
    t = rng.uniform(-cfg.trans_max, cfg.trans_max, 3).astype(np.float32)

    out = dict(frame)
    p1, p2 = frame["pos1"], frame["pos2"]
    out["pos1"] = p1 @ a.T + t
    out["pos2"] = p2 @ a.T + t
    for key in ("gt", "ego_flow"):
        if key in frame:
            # flow transforms linearly (translation cancels)
            out[key] = frame[key] @ a.T
    if cfg.jitter_sigma > 0:
        for key in ("pos1", "pos2"):
            j = np.clip(
                rng.normal(scale=cfg.jitter_sigma, size=out[key].shape),
                -cfg.jitter_clip, cfg.jitter_clip,
            ).astype(np.float32)
            out[key] = out[key] + j
    return out
