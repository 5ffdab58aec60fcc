"""The port's host-side copies and its small public functions against the
JAX package, on the CPU.

- ``data/transforms.py::augment_pair`` on tests/test_aux.py's inputs with
  the same seed (with and without jitter): every array equal;
- ``ops/hpr.py::hidden_point_removal`` and ``data/setcover.py::
  PositionSelector.next_best_view`` on tests/test_aux.py's scenes: masks,
  picks and values equal;
- ``utils/calibration.py::Calibration`` on tests/test_sceneflow_gen.py's
  calib file: matrices and transforms equal;
- ``ops/interp.py::knn_interpolate`` / ``three_nn_interpolate``,
  ``ops/morton.py::morton_argsort`` / ``knn_windowed``, ``ops/se3.py::
  pose_identity`` / ``pose_from_rt`` / ``pose_to_mat4`` within 1e-6, with
  integer outputs equal; ``config.py::for_variant`` equal field by field.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)
TOL = 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("jitter", [0.0, 0.01])
def test_augment_pair_matches_jax(jitter):
    from ssf_slam_tpu.data import transforms as jt
    from ssf_slam_tpu_torch.data import transforms as tt

    def frame():
        rng = np.random.default_rng(0)
        pos1 = rng.uniform(-10, 10, (500, 3)).astype(np.float32)
        gt = rng.normal(size=(500, 3)).astype(np.float32)
        return dict(pos1=pos1, pos2=pos1 + gt, gt=gt, ego_flow=gt * 0.5), rng

    f, rng = frame()
    want = jt.augment_pair(f, rng, jt.AugmentConfig(jitter_sigma=jitter))
    f, rng = frame()
    got = tt.augment_pair(f, rng, tt.AugmentConfig(jitter_sigma=jitter))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert dataclasses.asdict(tt.AugmentConfig()) == dataclasses.asdict(
        jt.AugmentConfig())


def test_hidden_point_removal_matches_jax():
    from ssf_slam_tpu.ops import hpr as jh
    from ssf_slam_tpu_torch.ops import hpr as th

    g = np.linspace(-3, 3, 40)
    yy, zz = np.meshgrid(g, g)
    wall = np.stack([np.full(yy.size, 5.0), yy.ravel(), zz.ravel()], 1)
    g2 = np.linspace(-1.5, 1.5, 10)
    y2, z2 = np.meshgrid(g2, g2)
    behind = np.stack([np.full(y2.size, 10.0), y2.ravel(), z2.ravel()], 1)
    pts = np.concatenate([wall, behind])
    vis = th.hidden_point_removal(pts, np.zeros(3))
    np.testing.assert_array_equal(vis, jh.hidden_point_removal(
        pts, np.zeros(3)))
    assert vis[:len(wall)].mean() > 0.3 and vis[len(wall):].mean() < 0.1
    view = np.array([1.0, 0.5, -0.2])
    np.testing.assert_array_equal(th.spherical_flip(pts, view),
                                  jh.spherical_flip(pts, view))


def test_set_cover_next_best_view_matches_jax():
    from ssf_slam_tpu.data import setcover as js
    from ssf_slam_tpu_torch.data import setcover as ts

    rng = np.random.default_rng(3)
    a = rng.uniform(-2, 2, (300, 3)) + np.array([20, 0, 0])
    b = rng.uniform(-2, 2, (300, 3)) + np.array([-20, 0, 0])
    pts = np.concatenate([a, b])
    cands = np.array([[20, 5, 1], [-20, 5, 1], [0, 0, 0]], float)
    jsel = js.PositionSelector(pts, max_range=15.0)
    tsel = ts.PositionSelector(pts, max_range=15.0)
    picks = []
    for _ in range(3):
        got, want = tsel.next_best_view(cands), jsel.next_best_view(cands)
        assert got == want
        assert tsel.covered == jsel.covered
        picks.append(got[0])
    assert set(picks[:2]) == {0, 1}
    np.testing.assert_array_equal(ts.voxel_keys(pts, 0.5),
                                  js.voxel_keys(pts, 0.5))


def test_calibration_matches_jax(tmp_path):
    from ssf_slam_tpu.utils.calibration import Calibration as JC
    from ssf_slam_tpu_torch.utils.calibration import Calibration as TC

    path = tmp_path / "calib.txt"
    path.write_text(
        "P2: 700 0 600 0 0 700 200 0 0 0 1 0\n"
        "R0_rect: 1 0 0 0 1 0 0 0 1\n"
        "Tr_velo_to_cam: 0 -1 0 0 0 0 -1 0 1 0 0 0\n")
    got, want = TC.from_file(str(path)), JC.from_file(str(path))
    for attr in ("P2", "R0", "V2C"):
        np.testing.assert_array_equal(getattr(got, attr),
                                      getattr(want, attr))
    velo = np.random.default_rng(4).uniform(-20, 20, (64, 3))
    for fn in ("velo_to_cam", "cam_to_velo", "project_to_image"):
        np.testing.assert_array_equal(getattr(got, fn)(velo),
                                      getattr(want, fn)(velo), err_msg=fn)


def _clouds(seed: int = 5, n: int = 512, s: int = 128):
    rng = np.random.default_rng(seed)
    dense = rng.uniform(-20, 20, (2, n, 3)).astype(np.float32)
    sparse = rng.uniform(-20, 20, (2, s, 3)).astype(np.float32)
    feats = rng.normal(size=(2, s, 5)).astype(np.float32)
    mask = rng.uniform(size=(2, s)) > 0.2
    return dense, sparse, feats, mask


@pytest.mark.parametrize("masked", [False, True])
def test_knn_interpolate_matches_jax(masked):
    import jax.numpy as jnp

    from ssf_slam_tpu.ops import interp as ji
    from ssf_slam_tpu_torch.ops import interp as ti

    dense, sparse, feats, mask = _clouds()
    m = mask if masked else None
    want = ji.knn_interpolate(jnp.asarray(dense), jnp.asarray(sparse),
                              jnp.asarray(feats), k=5,
                              sparse_mask=None if m is None
                              else jnp.asarray(m), clamp=1.5)
    got = ti.knn_interpolate(_t(dense), _t(sparse), _t(feats), k=5,
                             sparse_mask=None if m is None else _t(m),
                             clamp=1.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    want3 = ji.three_nn_interpolate(jnp.asarray(dense), jnp.asarray(sparse),
                                    jnp.asarray(feats))
    got3 = ti.three_nn_interpolate(_t(dense), _t(sparse), _t(feats))
    np.testing.assert_allclose(got3.numpy(), np.asarray(want3), atol=TOL)


def test_morton_argsort_and_knn_windowed_match_jax():
    import jax.numpy as jnp

    from ssf_slam_tpu.ops import morton as jm
    from ssf_slam_tpu_torch.ops import morton as tm

    rng = np.random.default_rng(6)
    # a 1 cm grid quantises many points into shared codes: ties
    pts = np.round(rng.uniform(-30, 30, (2048, 3)), 0).astype(np.float32)
    query = (pts[:512] + rng.normal(0, 0.5, (512, 3))).astype(np.float32)
    mask = rng.uniform(size=2048) > 0.1
    for m in (None, mask):
        jperm = np.asarray(jm.morton_argsort(
            jnp.asarray(pts), None if m is None else jnp.asarray(m)))
        tperm = tm.morton_argsort(_t(pts), None if m is None else _t(m))
        np.testing.assert_array_equal(tperm.numpy(), jperm)
    origin, scale = np.array([-31.0, -31, -31], np.float32), np.float32(62)
    np.testing.assert_array_equal(
        tm.morton_argsort(_t(pts), origin=_t(origin), scale=_t(scale)).numpy(),
        np.asarray(jm.morton_argsort(jnp.asarray(pts),
                                     origin=jnp.asarray(origin),
                                     scale=jnp.asarray(scale))))
    ps = pts[jperm]
    ms = mask[jperm]
    qs = query[np.asarray(jm.morton_argsort(jnp.asarray(query)))]
    for m in (None, ms):
        jd, ji_ = jm.knn_windowed(jnp.asarray(qs), jnp.asarray(ps), 8,
                                  window=64, points_mask=None if m is None
                                  else jnp.asarray(m))
        td, ti_ = tm.knn_windowed(_t(qs), _t(ps), 8, window=64,
                                  points_mask=None if m is None else _t(m))
        np.testing.assert_array_equal(ti_.numpy(), np.asarray(ji_))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=TOL)


def test_pose_helpers_match_jax():
    import jax.numpy as jnp
    from scipy.spatial.transform import Rotation

    from ssf_slam_tpu.ops import se3 as js
    from ssf_slam_tpu_torch.ops import se3 as ts

    jq, jt = js.pose_identity()
    tq, tt = ts.pose_identity("cpu")
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tq.dtype == tt.dtype == torch.float32
    rng = np.random.default_rng(7)
    mats = Rotation.from_rotvec(rng.normal(0, 1.0, (16, 3))).as_matrix()
    mats = mats.astype(np.float32)
    t = rng.normal(0, 5, (16, 3)).astype(np.float32)
    jpose = js.pose_from_rt(jnp.asarray(mats), jnp.asarray(t))
    tpose = ts.pose_from_rt(_t(mats), _t(t))
    for a, b in zip(tpose, jpose):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)
    np.testing.assert_allclose(ts.pose_to_mat4(tpose).numpy(),
                               np.asarray(js.pose_to_mat4(jpose)), atol=TOL)


def test_for_variant_matches_jax():
    from ssf_slam_tpu import config as jc
    from ssf_slam_tpu_torch import config as tc

    for v in tc.Variant:
        got = tc.for_variant(v, max_scans=64)
        want = jc.for_variant(jc.Variant[v.name], max_scans=64)
        assert isinstance(got, tc.PipelineConfig)
        assert got.variant is v and got.max_scans == 64
        assert dataclasses.asdict(got.replace(variant=None)) == \
            dataclasses.asdict(want.replace(variant=None))
