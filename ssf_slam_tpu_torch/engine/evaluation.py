"""Trajectory files and errors, the port's copy of
ssf_slam_tpu/engine/evaluation.py (numpy and scipy; no JAX):

- TUM trajectories (``time tx ty tz qx qy qz qw`` lines, the reference's
  RESULT_PATH writer, src/mapOptmization.cpp:353-374);
- ATE with Umeyama alignment and evo's relative pose error, the reference's
  evaluation protocol (`evo_traj kitti ... --ref=00_Seg.kitti`,
  README.md:64-72).

tests/test_torch_variants.py holds each function to the original.
"""

from __future__ import annotations

import numpy as np


def write_tum(path: str, times, positions, quats) -> None:
    """Write a TUM trajectory (overwriting ``path``)."""
    with open(path, "w") as f:
        for t, p, q in zip(times, positions, quats):
            f.write(
                f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                f"{q[0]:.6f} {q[1]:.6f} {q[2]:.6f} {q[3]:.6f}\n"
            )


def read_tum(path: str):
    """(times [N], positions [N, 3], xyzw quaternions [N, 4])."""
    data = np.loadtxt(path).reshape(-1, 8)
    return data[:, 0], data[:, 1:4], data[:, 4:8]


def umeyama_align(est: np.ndarray, ref: np.ndarray):
    """SE(3) alignment est -> ref (no scale), as evo's ATE alignment."""
    mu_e, mu_r = est.mean(0), ref.mean(0)
    h = (est - mu_e).T @ (ref - mu_r)
    u, _, vt = np.linalg.svd(h)
    d = np.sign(np.linalg.det(vt.T @ u.T))
    r = vt.T @ np.diag([1.0, 1.0, d]) @ u.T
    return r, mu_r - r @ mu_e


def ate_rmse(est_pos: np.ndarray, ref_pos: np.ndarray,
             align: bool = True) -> float:
    """Absolute trajectory error RMSE over associated positions."""
    est, ref = np.asarray(est_pos, float), np.asarray(ref_pos, float)
    if est.shape != ref.shape:
        raise ValueError(f"shape mismatch {est.shape} vs {ref.shape}")
    if align and len(est) >= 3:
        r, t = umeyama_align(est, ref)
        est = est @ r.T + t
    err = np.linalg.norm(est - ref, axis=1)
    return float(np.sqrt(np.mean(err ** 2)))


def _as_rotmats(rot: np.ndarray) -> np.ndarray:
    """[N, 3, 3] rotation matrices from matrices or [N, 4] xyzw quaternions."""
    rot = np.asarray(rot, float)
    if rot.ndim == 3 and rot.shape[-2:] == (3, 3):
        return rot
    from scipy.spatial.transform import Rotation

    return Rotation.from_quat(rot).as_matrix()


def rpe(est_pos: np.ndarray, est_rot: np.ndarray, ref_pos: np.ndarray,
        ref_rot: np.ndarray, delta: int = 1) -> dict:
    """evo's relative pose error over frame-delta pairs: for each pair
    (i, i + delta) the relative motions Q = inv(P_i) P_{i+d} of estimate and
    reference, and the error E = inv(Q_ref) Q_est scored by ||trans(E)||
    (m) and angle(rot(E)) (degrees). Rotations as [N, 3, 3] matrices or
    [N, 4] xyzw quaternions. Returns dict(trans_rmse, trans_mean,
    rot_rmse_deg, rot_mean_deg)."""
    re_, rr = _as_rotmats(est_rot), _as_rotmats(ref_rot)
    te = np.asarray(est_pos, float)
    tr = np.asarray(ref_pos, float)
    if te.shape != tr.shape or len(te) <= delta:
        raise ValueError(f"shapes {te.shape} vs {tr.shape}, delta {delta}")

    def rel(r, t):
        ri = np.swapaxes(r[:-delta], -1, -2)
        return ri @ r[delta:], np.einsum(
            "nij,nj->ni", ri, t[delta:] - t[:-delta]
        )

    dre, dte = rel(re_, te)
    drr, dtr = rel(rr, tr)
    rri = np.swapaxes(drr, -1, -2)
    err_r = rri @ dre
    err_t = np.einsum("nij,nj->ni", rri, dte - dtr)
    trans = np.linalg.norm(err_t, axis=1)
    cos = np.clip((np.trace(err_r, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    ang = np.degrees(np.arccos(cos))
    return dict(
        trans_rmse=float(np.sqrt(np.mean(trans ** 2))),
        trans_mean=float(np.mean(trans)),
        rot_rmse_deg=float(np.sqrt(np.mean(ang ** 2))),
        rot_mean_deg=float(np.mean(ang)),
    )


def rpe_rmse(est_pos: np.ndarray, ref_pos: np.ndarray, est_rot: np.ndarray,
             ref_rot: np.ndarray, delta: int = 1) -> float:
    """Translation RMSE of ``rpe`` (rotations are required: without them
    the relative pose error is ill-defined)."""
    return rpe(est_pos, est_rot, ref_pos, ref_rot, delta=delta)["trans_rmse"]
