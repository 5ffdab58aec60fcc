"""Pose-file conversions, the port's copy of ssf_slam_tpu/utils/poses.py
(numpy and scipy; no JAX): KITTI pose lines and the TUM -> KITTI step of
the evaluation protocol (README.md:64-72). ``tum_file_to_kitti`` reads
through the port's own ``engine/evaluation.py::read_tum``.
tests/test_torch_variants.py holds each function to the original.
"""

from __future__ import annotations

import numpy as np


def kitti_to_mat(line: str) -> np.ndarray:
    """One KITTI-odometry pose line (12 floats, row-major 3x4) -> 4x4."""
    vals = np.array(line.split(), dtype=float)
    m = np.eye(4)
    m[:3, :4] = vals.reshape(3, 4)
    return m


def mat_to_kitti(m: np.ndarray) -> str:
    return " ".join(f"{v:.6e}" for v in np.asarray(m)[:3, :4].reshape(-1))


def read_kitti_poses(path: str) -> np.ndarray:
    """[N, 4, 4] from a KITTI poses.txt."""
    with open(path) as f:
        return np.stack([kitti_to_mat(line) for line in f if line.strip()])


def write_kitti_poses(path: str, mats: np.ndarray) -> None:
    with open(path, "w") as f:
        for m in mats:
            f.write(mat_to_kitti(m) + "\n")


def tum_to_mats(times, positions, quats) -> np.ndarray:
    """TUM arrays (t, xyz, xyzw quaternions) -> [N, 4, 4]."""
    from scipy.spatial.transform import Rotation

    out = np.tile(np.eye(4), (len(times), 1, 1))
    out[:, :3, :3] = Rotation.from_quat(np.asarray(quats)).as_matrix()
    out[:, :3, 3] = positions
    return out


def tum_file_to_kitti(tum_path: str, kitti_path: str) -> None:
    """Convert a written TUM trajectory to KITTI format (the evo_traj step
    of the protocol, README.md:69-71)."""
    from ssf_slam_tpu_torch.engine.evaluation import read_tum

    t, p, q = read_tum(tum_path)
    write_kitti_poses(kitti_path, tum_to_mats(t, p, q))


def relative_pose(m_a: np.ndarray, m_b: np.ndarray) -> np.ndarray:
    """T_a^-1 T_b."""
    return np.linalg.inv(m_a) @ m_b
