"""The numbers that decide ``correct``: what the program produced against
what the plain reference produced from the same inputs.

A drive (the offline runner's or the stream's) is judged scan by scan
and stage by stage: the network's output (its flow and seg logit) against
the reference network on the same raw clouds; the SLAM step's ego-motion
``rel_q``/``rel_t``, map pose ``pose_q``/``pose_t`` and ``is_keyframe``
against the reference SLAM step run on the program's flow and static
mask.
"""

from __future__ import annotations

import numpy as np

# a point whose flow lies farther than this from the reference's (m) is
# counted as far in ``flow_far_share``
FAR_M = 0.1


def quat_angle(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    """Rotation angle (rad) between quaternions [..., 4] (x, y, z, w), in
    float64: 2 atan2(|v|, |w|) of the relative rotation conj(q1) q2."""
    a = np.asarray(q1, np.float64)
    b = np.asarray(q2, np.float64)
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    av, aw, bv, bw = a[..., :3], a[..., 3:], b[..., :3], b[..., 3:]
    v = aw * bv - bw * av - np.cross(av, bv)  # vector part of conj(a) b
    w = np.sum(a * b, axis=-1)
    return 2.0 * np.arctan2(np.linalg.norm(v, axis=-1), np.abs(w))


def drive_numbers(got: dict, want: dict, valid: np.ndarray) -> dict:
    """One drive, stage by stage. ``got`` holds what the judged side
    produced: pose_q/pose_t, rel_q/rel_t, is_keyframe [F], the network's
    flow [F, N, 3+], and the joint head's seg logit ``seg`` and ``static``
    mask [F, N]; ``want`` the reference's (``run_drive`` given ``got``):
    its network on the raw clouds, its SLAM step on ``got``'s flow and
    mask. ``valid`` [F, N] marks the real points of each pair's first
    cloud.

    - flow_rms_m: the median over scans of the RMS over valid points of
      the flow's difference (m); flow_max_scan_m its largest scan;
    - flow_far_share: the largest over scans of the share of valid points
      whose flow lies more than ``FAR_M`` from the reference's: a fault
      on one scan of a drive shows here, where the median scan hides it;
    - seg_rms: the RMS of the seg margin's difference over the drive's
      valid points; static_mismatch the share whose mask differs;
    - rel_t_m, rel_rot_rad, pose_t_m, pose_rot_rad: the largest
      difference over scans of the ego-motion and the map pose;
    - keyframes_differ: scans whose keyframe decision differs.
    A cell's limits file names the ones it compares."""
    n_valid = max(valid.sum(), 1)
    d = got["flow"][..., :3].astype(np.float64) - want["flow"][..., :3]
    sq = np.sum(d * d, axis=-1) * valid
    per_valid = np.maximum(valid.sum(-1), 1)
    per_scan = np.sqrt(sq.sum(-1) / per_valid)
    far = ((sq > FAR_M * FAR_M) & valid).sum(-1) / per_valid
    ds = (got["seg"].astype(np.float64) - want["seg"]) * valid
    mism = (got["static"] != want["static"]) & valid
    return dict(
        flow_rms_m=float(np.median(per_scan)),
        flow_max_scan_m=float(per_scan.max()),
        flow_far_share=float(far.max()),
        seg_rms=float(np.sqrt(np.sum(ds * ds) / n_valid)),
        static_mismatch=float(mism.sum() / n_valid),
        rel_t_m=float(np.linalg.norm(
            got["rel_t"].astype(np.float64) - want["rel_t"], axis=-1).max()),
        rel_rot_rad=float(quat_angle(got["rel_q"], want["rel_q"]).max()),
        pose_t_m=float(np.linalg.norm(
            got["pose_t"].astype(np.float64) - want["pose_t"],
            axis=-1).max()),
        pose_rot_rad=float(quat_angle(got["pose_q"], want["pose_q"]).max()),
        keyframes_differ=float(np.sum(got["is_keyframe"]
                                      != want["is_keyframe"])),
    )

