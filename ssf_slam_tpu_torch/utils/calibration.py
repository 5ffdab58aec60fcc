"""KITTI-style sensor calibration: the port's copy of
``ssf_slam_tpu/utils/calibration.py`` (numpy only; tests/test_torch_aux.py
holds it to the original on the same file).

Parses calib files with P0..P3 / R0_rect / Tr_velo_to_cam entries and
gives the frame transforms used when importing KITTI-format data.
"""

from __future__ import annotations

import numpy as np


class Calibration:
    def __init__(self, entries: dict):
        self.P2 = entries.get("P2", np.eye(3, 4)).reshape(3, 4)
        r0 = entries.get("R0_rect", np.eye(3))
        self.R0 = r0.reshape(3, 3)
        tr = entries.get("Tr_velo_to_cam", np.eye(3, 4))
        self.V2C = tr.reshape(3, 4)

    @classmethod
    def from_file(cls, path: str) -> "Calibration":
        entries = {}
        with open(path) as f:
            for line in f:
                if ":" not in line:
                    continue
                key, vals = line.split(":", 1)
                try:
                    entries[key.strip()] = np.fromstring(vals, sep=" ")
                except ValueError:
                    continue
        return cls(entries)

    def velo_to_cam(self, pts: np.ndarray) -> np.ndarray:
        """[N,3] velodyne frame -> rectified camera frame."""
        homo = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
        return (self.R0 @ (self.V2C @ homo.T)).T

    def cam_to_velo(self, pts: np.ndarray) -> np.ndarray:
        r = self.V2C[:, :3]
        t = self.V2C[:, 3]
        back = self.R0.T @ pts.T
        return (r.T @ (back - t[:, None])).T

    def project_to_image(self, pts_velo: np.ndarray) -> np.ndarray:
        """[N,3] velodyne -> [N,2] pixel coordinates (P2 camera)."""
        cam = self.velo_to_cam(pts_velo)
        homo = np.concatenate([cam, np.ones((len(cam), 1))], axis=1)
        uvw = (self.P2 @ homo.T).T
        return uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-9)
