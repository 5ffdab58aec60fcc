"""The ONLY_PC odometry's pieces and ``geom_refine`` against the JAX
package, on the CPU: the BEV init (``odometry/bev_init.py``), the
ring-diverse plane fit and the scan-to-scan Gauss-Newton
(``odometry/scan2scan.py``) and the flow-pose refine
(``odometry/flow_refine.py``), on the same numpy inputs (frames 0-4 of the
seed-100 sequence at 8192 points and their plane features). Tolerances
(float32 on both sides):
- ``bev_pose_init``, without and with the constant-velocity window
  (``pred_t`` at the motion, off it, and still): the yaw equal, t within
  1e-4 m. Where the best two yaws' scores tie within 1e-3 the FFT's
  rounding may pick either: the test then holds the picked yaw's score,
  not its index (and prints the top two); ``bev_translation_init`` equal;
- ``_ring_diverse_five`` exact; ``fit_ring_diverse_planes``: ``valid``
  equal, the valid planes' normals within 1e-5 (an invalid plane's normal
  is read by nothing);
- ``scan_to_scan`` on one pair, each hypothesis rule, with and without the
  current normals and the BEV init: q within 1e-5, t within 1e-4 m,
  ``n_inliers`` equal;
- ``refine_flow_pose``, accepted and rejected: q 1e-5, t 1e-4 m.
The kNN expansion rounds as XLA's CPU compiler rounds it
(``torch_ref.round_knn_like_xla_cpu``), as in tests/test_torch_variants.py.

The tie that splits the ONLY_PC evo run (ROADMAP §3): frame 20 of the
seed-100 sequence (40 frames x 8192 points, the default step), whose
``bev_pose_init`` inputs are committed (``bev_tie_frame20.npz``, the
port's ONLY_PC state there, within 1e-5 m of JAX's). There a windowed
peak's overlap count (64) equals its neighbour's exactly, so the
local-max test ``c0 >= max(nb)`` is decided by each FFT's rounding: JAX
reads 63.999996 against 64 and drops the candidate, the port reads 64
against 64 and keeps it, and the two pick other yaws. The fixture is made
by

    python tests/test_torch_bev.py --make-fixture
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ref  # noqa: E402
from test_torch_variants import Q_TOL, T_TOL, _np, _t  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _xla_cpu_knn(monkeypatch):
    torch_ref.round_knn_like_xla_cpu(monkeypatch)


@pytest.fixture(scope="module")
def street():
    """Frames 0-4 of the seed-100 sequence at 8192 points, with their
    plane features (the port's, held to the JAX package's elsewhere)."""
    from ssf_slam_tpu_torch import config as tc
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence
    from ssf_slam_tpu_torch.frontend.features import extract_plane_features

    frames = generate_sequence(n_frames=5, n_points=8192, seed=100,
                               noise=0.004, n_moving=4)
    feats = [extract_plane_features(_t(f["pos1"].astype(np.float32)),
                                    _t(f["mask1"].astype(bool)),
                                    tc.LidarConfig(), tc.FeatureConfig())
             for f in frames]
    return frames, feats


def _jax_cloud(c):
    import jax.numpy as jnp

    from ssf_slam_tpu.frontend.features import FeatureCloud

    return FeatureCloud(xyz=jnp.asarray(c.xyz.numpy()),
                        ring=jnp.asarray(c.ring.numpy()),
                        mask=jnp.asarray(c.mask.numpy()))


def _jax_planes(p):
    import jax.numpy as jnp

    from ssf_slam_tpu.odometry.scan2scan import PlaneModel

    return PlaneModel(normal=jnp.asarray(p.normal.numpy()),
                      valid=jnp.asarray(p.valid.numpy()))


# pred_t of the BEV window: none, at the motion (~1.22 m along x), off it
# by 0.6 m (the global argmax implausible), and still (no velocity)
BEV_PRED = {"global": None, "at_motion": (1.2, 0.0, 0.0),
            "off_motion": (0.6, 0.3, 0.0), "still": (0.01, 0.0, 0.0)}


@pytest.mark.parametrize("pred", list(BEV_PRED))
def test_bev_pose_init_matches_jax(street, pred):
    import jax.numpy as jnp

    from ssf_slam_tpu.odometry.bev_init import bev_pose_init as jbev
    from ssf_slam_tpu_torch.odometry import bev_init as tb

    frames, _ = street
    last, curr = frames[2], frames[3]
    # a yaw offset of the current scan, so the pick is not the middle yaw
    c, s = np.cos(0.05), np.sin(0.05)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    cxyz = (curr["pos1"] @ rot.T).astype(np.float32)
    args = (cxyz, curr["mask1"].astype(bool),
            last["pos1"].astype(np.float32), last["mask1"].astype(bool))
    kw = {}
    if BEV_PRED[pred] is not None:
        kw = dict(pred_t=np.asarray(BEV_PRED[pred], np.float32),
                  plaus_gate=0.4, plaus_rel=0.5)
    jy, jt = _np(jbev(*map(jnp.asarray, args),
                      **{k: jnp.asarray(v) if k == "pred_t" else v
                         for k, v in kw.items()}))
    ty, tt = tb.bev_pose_init(*map(_t, args),
                              **{k: _t(v) if k == "pred_t" else v
                                 for k, v in kw.items()})
    # the port's per-yaw global scores, to tell a tie from a fault
    yaws = tb._yaw_candidates(0.1, 11, "cpu")
    yc, ys = torch.cos(yaws)[:, None], torch.sin(yaws)[:, None]
    x, y = _t(cxyz)[None, :, 0], _t(cxyz)[None, :, 1]
    rotated = torch.stack([x * yc - y * ys, x * ys + y * yc,
                           _t(cxyz)[None, :, 2].expand(11, -1)], dim=-1)
    scores = tb._correlate(rotated, _t(args[1]), _t(args[2]), _t(args[3]),
                           0.25, 64.0, 8.0, -1.2)[1].numpy()
    top = np.sort(scores)[::-1][:2]
    print(f"{pred}: top two yaw scores {top}, yaw JAX {float(jy):.6f} "
          f"port {float(ty):.6f}")
    if top[0] - top[1] > 1e-3:
        assert float(ty) == float(jy)
        np.testing.assert_allclose(tt.numpy(), jt, atol=T_TOL)
    else:  # a tie: the FFT's rounding picks; hold the picked score
        pick_j = int(np.argmin(np.abs(yaws.numpy() - float(jy))))
        pick_t = int(np.argmin(np.abs(yaws.numpy() - float(ty))))
        assert abs(scores[pick_j] - scores[pick_t]) <= 1e-3


def test_bev_translation_init_matches_jax(street):
    import jax.numpy as jnp

    from ssf_slam_tpu.odometry.bev_init import bev_translation_init as jf
    from ssf_slam_tpu_torch.odometry.bev_init import bev_translation_init as tf

    frames, _ = street
    args = (frames[3]["pos1"], frames[3]["mask1"].astype(bool),
            frames[2]["pos1"], frames[2]["mask1"].astype(bool))
    args = tuple(a.astype(np.float32) if a.dtype != bool else a
                 for a in args)
    np.testing.assert_array_equal(tf(*map(_t, args)).numpy(),
                                  np.asarray(jf(*map(jnp.asarray, args))))


def test_ring_diverse_five_matches_jax():
    import jax.numpy as jnp

    from ssf_slam_tpu.odometry.scan2scan import _ring_diverse_five as jf
    from ssf_slam_tpu_torch.odometry.scan2scan import _ring_diverse_five as tf

    rng = np.random.default_rng(3)
    d = np.sort(rng.uniform(0, 4, (512, 16)), axis=1).astype(np.float32)
    # few rings, so that rows with none, one and two other rings occur
    ring = rng.choice([3, 3, 3, 3, 4, 5, 70, -1], (512, 16)).astype(np.int32)
    js = _np(jf(jnp.asarray(d), jnp.asarray(ring), 16))[0]
    np.testing.assert_array_equal(tf(_t(ring), 16).numpy(), js)
    assert len(np.unique(js[:, 3:], axis=0)) > 3


def test_fit_ring_diverse_planes_matches_jax(street):
    from ssf_slam_tpu.config import OdometryConfig as JOdometryConfig
    from ssf_slam_tpu.odometry.scan2scan import fit_ring_diverse_planes as jf
    from ssf_slam_tpu_torch.odometry.scan2scan import (
        fit_ring_diverse_planes as tf,
    )

    _, feats = street
    want = _np(jf(_jax_cloud(feats[2]), JOdometryConfig()))
    got = tf(feats[2])
    valid = got.valid.numpy()
    np.testing.assert_array_equal(valid, want.valid)
    assert valid.sum() > 100
    np.testing.assert_allclose(got.normal.numpy()[valid],
                               want.normal[valid], atol=1e-5)


# hypothesis rule, current normals given, BEV init on
S2S_CASES = {"bev": ("bev", True, True), "score": ("score", True, True),
             "warm": ("warm", True, True), "plain_nn": ("bev", False, True),
             "no_bev": ("bev", True, False)}


@pytest.mark.parametrize("case", list(S2S_CASES))
def test_scan_to_scan_matches_jax(street, case):
    import jax.numpy as jnp

    from ssf_slam_tpu import config as jc
    from ssf_slam_tpu.odometry import scan2scan as js
    from ssf_slam_tpu_torch import config as tc
    from ssf_slam_tpu_torch.odometry import scan2scan as ts

    pick, normals, bev = S2S_CASES[case]
    _, feats = street
    curr, last = feats[3], feats[2]
    last_planes = ts.fit_ring_diverse_planes(last)
    curr_planes = ts.fit_ring_diverse_planes(curr) if normals else None
    # a stale warm start: 0.3 m and 0.01 rad off the motion
    q0 = np.array([0.0, 0.0, 0.005, 1.0], np.float32)
    q0 /= np.linalg.norm(q0)
    t0 = np.array([0.9, 0.05, 0.0], np.float32)
    kw = dict(hypothesis_pick=pick, bev_init=bev)
    want = _np(js.scan_to_scan(
        _jax_cloud(curr), _jax_cloud(last), _jax_planes(last_planes),
        jnp.asarray(q0), jnp.asarray(t0), jc.OdometryConfig(**kw),
        curr_planes=None if curr_planes is None else _jax_planes(
            curr_planes)))
    got = ts.scan_to_scan(curr, last, last_planes, _t(q0), _t(t0),
                          tc.OdometryConfig(**kw), curr_planes=curr_planes)
    assert int(want[2]) > 100
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=Q_TOL)
    np.testing.assert_allclose(got[1].numpy(), want[1], atol=T_TOL)
    assert int(got[2]) == int(want[2])


@pytest.mark.parametrize("gate", ["accepted", "rejected"])
def test_refine_flow_pose_matches_jax(street, gate):
    import jax.numpy as jnp

    from ssf_slam_tpu import config as jc
    from ssf_slam_tpu.odometry.flow_refine import refine_flow_pose as jf
    from ssf_slam_tpu_torch import config as tc
    from ssf_slam_tpu_torch.odometry.egomotion import ego_motion_from_flow
    from ssf_slam_tpu_torch.odometry.flow_refine import refine_flow_pose
    from ssf_slam_tpu_torch.odometry.scan2scan import fit_ring_diverse_planes

    frames, feats = street
    prev = frames[2]
    pts = prev["pos1"].astype(np.float32)
    static = (prev["s_fg_mask"] < 0.5) & prev["mask1"].astype(bool)
    # the flow pose of a biased flow: the refine's correction is real
    q0, t0 = ego_motion_from_flow(_t(pts), _t(prev["gt"] * 1.03),
                                  _t(static))
    planes = fit_ring_diverse_planes(feats[3])
    # rejected: the inlier gate cannot be met
    kw = {} if gate == "accepted" else dict(refine_min_inliers=10 ** 6)
    want = _np(jf(jnp.asarray(pts), jnp.asarray(static),
                  _jax_cloud(feats[3]), _jax_planes(planes),
                  jnp.asarray(q0.numpy()), jnp.asarray(t0.numpy()),
                  jc.EgoMotionConfig(**kw)))
    got = refine_flow_pose(_t(pts), _t(static), feats[3], planes, q0, t0,
                           tc.EgoMotionConfig(**kw))
    moved = float(np.abs(want[1] - t0.numpy()).max())
    assert (moved > 1e-3) == (gate == "accepted"), moved
    np.testing.assert_allclose(got[0].numpy(), want[0], atol=Q_TOL)
    np.testing.assert_allclose(got[1].numpy(), want[1], atol=T_TOL)


TIE_REF = os.path.join(torch_ref.FIXTURE_DIR, "bev_tie_frame20.npz")
TIE_FRAME, TIE_YAW = 20, 6  # the frame and the yaw candidate of the tie


def make_tie_fixture(path: str = TIE_REF) -> None:
    """The inputs of ``bev_pose_init`` at frame 20 of the port's ONLY_PC
    run over the seed-100 sequence (the default step)."""
    from ssf_slam_tpu_torch import config as tc
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence
    from ssf_slam_tpu_torch.engine.pipeline import run_sequence
    from ssf_slam_tpu_torch.odometry import bev_init

    frames = generate_sequence(n_frames=TIE_FRAME + 1, n_points=8192,
                               seed=100, noise=0.004, n_moving=4)
    calls, plain = [], bev_init.bev_pose_init

    def spy(*args, **kw):
        calls.append((args, kw))
        return plain(*args, **kw)

    bev_init.bev_pose_init = spy
    try:
        run_sequence(frames, tc.PipelineConfig(), device="cpu")
    finally:
        bev_init.bev_pose_init = plain
    args, kw = calls[-1]  # frame 0 has no pair: call k is frame k + 1
    np.savez(path, **dict(zip(("curr_xyz", "curr_mask", "last_xyz",
                               "last_mask"), (a.numpy() for a in args))),
             pred_t=kw["pred_t"].numpy(), plaus_gate=kw["plaus_gate"],
             plaus_rel=kw["plaus_rel"])
    print(f"wrote {path}")


def test_bev_local_max_tie_splits_the_packages():
    import jax.numpy as jnp

    from ssf_slam_tpu.odometry import bev_init as jb
    from ssf_slam_tpu_torch.odometry import bev_init as tb

    with np.load(TIE_REF) as z:
        ref = {k: z[k] for k in z.files}
    args = [ref[k] for k in ("curr_xyz", "curr_mask", "last_xyz",
                             "last_mask")]
    kw = dict(plaus_gate=float(ref["plaus_gate"]),
              plaus_rel=float(ref["plaus_rel"]))
    jy, jt = _np(jb.bev_pose_init(*map(jnp.asarray, args),
                                  pred_t=jnp.asarray(ref["pred_t"]), **kw))
    ty, tt = tb.bev_pose_init(*map(_t, args), pred_t=_t(ref["pred_t"]),
                              **kw)
    yaws = tb._yaw_candidates(0.1, 11, "cpu")
    # the packages pick other yaws: JAX -0.04 rad, the port +0.02
    assert int(np.argmin(np.abs(yaws.numpy() - float(jy)))) == 3
    assert int(np.argmin(np.abs(yaws.numpy() - float(ty)))) == TIE_YAW
    # per yaw, every score is the same whole count in both packages, and
    # only the windowed peak's local-max flag at the tied yaw differs
    c, s = torch.cos(yaws)[:, None], torch.sin(yaws)[:, None]
    xyz = _t(args[0])
    rot = torch.stack([xyz[None, :, 0] * c - xyz[None, :, 1] * s,
                       xyz[None, :, 0] * s + xyz[None, :, 1] * c,
                       xyz[None, :, 2].expand(11, -1)], dim=-1)
    pred = _t(ref["pred_t"])
    t_out = [a.numpy() for a in tb._correlate(
        rot, _t(args[1]), _t(args[2]), _t(args[3]), 0.25, 64.0, 8.0, -1.2,
        pred_t=pred, plaus_gate=kw["plaus_gate"])]
    j_out = [_np(jb._correlate(jnp.asarray(rot[i].numpy()),
                               *map(jnp.asarray, args[1:]), 0.25, 64.0, 8.0,
                               -1.2, pred_t=jnp.asarray(ref["pred_t"]),
                               plaus_gate=kw["plaus_gate"]))
             for i in range(11)]
    for k in (1, 3):  # the global and the windowed scores
        want = np.array([o[k] for o in j_out])
        np.testing.assert_allclose(t_out[k], want, atol=1e-4)
        np.testing.assert_array_equal(np.rint(t_out[k]), np.rint(want))
    flags = np.array([bool(o[4]) for o in j_out])
    differ = np.nonzero(t_out[4] != flags)[0]
    assert differ.tolist() == [TIE_YAW]
    assert t_out[4][TIE_YAW] and not flags[TIE_YAW]
    assert t_out[3][TIE_YAW] == 64.0 and j_out[TIE_YAW][3] < 64.0


if __name__ == "__main__":
    if sys.argv[1:] != ["--make-fixture"]:
        sys.exit("usage: python tests/test_torch_bev.py --make-fixture")
    make_tie_fixture()
