"""The port's mapping back end against the JAX package, on the CPU.

The same numpy inputs (from a seed) go through each JAX function and its
counterpart in ``ssf_slam_tpu_torch``. Tolerances (float32 on both sides):
- se3 helpers 1e-5 (2e-4 absolute on 20 m vectors); round trips 1e-5;
- kNN with masks and ``rerank=False``: indices EXACT, distances 1e-6
  relative. Every test here rounds the port's kNN expansion as XLA's CPU
  compiler rounds the JAX package's (``torch_ref.xla_cpu_sqdist``), since
  the back end thresholds those distances as they are;
- voxel filter: representatives EQUAL, centroids within 1e-6;
- eig3: eigenvalues 1e-5 relative, eigenvectors 1e-4 (the same closed
  form; near-degenerate pairs are excluded by the input);
- plane features: masks and rings EQUAL, xyz within 1e-6;
- ``fit_local_planes``: validity EQUAL, normals within 1e-4;
- ICP 1e-4 (R, t) and 1e-4 relative fitness; pose graph 1e-4;
- ``mapping_step`` over the miniature square loop: ``n_loops`` and the
  keyframe flags equal, ``kf_q/kf_t`` and ``cur_q/cur_t`` within 1e-4 at
  every step.
"""

from __future__ import annotations

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ref  # noqa: E402  (puts the repo on the path as a script)

from ssf_slam_tpu.ops import se3 as jse3  # noqa: E402
from ssf_slam_tpu_torch.ops import se3 as tse3  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _xla_cpu_knn(monkeypatch):
    torch_ref.round_knn_like_xla_cpu(monkeypatch)

TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _rand_quat(rng, shape=()):
    q = rng.normal(size=shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _lidar(rng, n):
    r = rng.uniform(3, 28, n)
    th = rng.uniform(0, 2 * np.pi, n)
    z = rng.normal(0, 1.5, n)
    return np.stack([r * np.cos(th), r * np.sin(th), z], -1).astype(
        np.float32)


def _street_scan(seed=0, n=8192):
    from ssf_slam_tpu.data.synthetic import generate_sequence

    f = generate_sequence(n_frames=1, n_points=n, seed=seed, noise=0.004,
                          n_moving=4)[0]
    return f["pos1"], f["mask1"].astype(bool)


@pytest.mark.parametrize("name", [
    "quat_conjugate", "quat_to_matrix", "quat_to_rpy", "so3_exp_quat",
    "so3_log_quat", "pose_inverse", "pose_apply", "pose_between"])
def test_se3_helpers(name):
    rng = np.random.default_rng(11)
    q1, q2 = _rand_quat(rng, (64,)), _rand_quat(rng, (64,))
    t1 = rng.normal(size=(64, 3)).astype(np.float32) * 20
    t2 = rng.normal(size=(64, 3)).astype(np.float32) * 20
    w = rng.normal(size=(64, 3)).astype(np.float32) * 0.5
    w[:4] *= 1e-7  # the small-angle series
    args = {
        "quat_conjugate": (q1,), "quat_to_matrix": (q1,),
        "quat_to_rpy": (q1,), "so3_exp_quat": (w,),
        "so3_log_quat": (q1,), "pose_inverse": ((q1, t1),),
        "pose_apply": ((q1, t1), t2),
        "pose_between": ((q1, t1), (q2, t2)),
    }[name]

    def conv(a, f):
        return tuple(conv(x, f) for x in a) if isinstance(a, tuple) else f(a)

    j = getattr(jse3, name)(*conv(args, jnp.asarray))
    t = getattr(tse3, name)(*conv(args, _t))
    j = j if isinstance(j, tuple) else (j,)
    t = t if isinstance(t, tuple) else (t,)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4,
                                   rtol=TOL)


def test_se3_round_trips():
    rng = np.random.default_rng(12)
    q = tse3.quat_normalize(_t(_rand_quat(rng, (64,))))
    t = _t(rng.normal(size=(64, 3)).astype(np.float32) * 20)
    w = _t(rng.normal(size=(64, 3)).astype(np.float32) * 0.5)
    torch.testing.assert_close(tse3.so3_log_quat(tse3.so3_exp_quat(w)), w,
                               atol=TOL, rtol=TOL)
    torch.testing.assert_close(
        tse3.matrix_to_quat(tse3.quat_to_matrix(q)), q, atol=TOL, rtol=TOL)
    qi, ti = tse3.pose_compose((q, t), tse3.pose_inverse((q, t)))
    torch.testing.assert_close(qi, tse3.quat_identity().expand(64, 4),
                               atol=TOL, rtol=0)
    torch.testing.assert_close(ti, torch.zeros(64, 3), atol=1e-4, rtol=0)


@pytest.mark.parametrize("k,approx,rerank", [
    (1, True, False), (8, True, False), (1, True, True), (5, False, True)])
def test_knn_masks_and_rerank(k, approx, rerank):
    from ssf_slam_tpu.ops.knn import knn as j_knn
    from ssf_slam_tpu_torch.ops.knn import knn as t_knn

    rng = np.random.default_rng(13 + k)
    q, p = _lidar(rng, 300), _lidar(rng, 700)
    pm = rng.uniform(size=700) < 0.7
    jd, ji = j_knn(jnp.asarray(q), jnp.asarray(p), k,
                   points_mask=jnp.asarray(pm), approx=approx, rerank=rerank,
                   query_chunk=128)
    td, ti = t_knn(_t(q), _t(p), k, points_mask=_t(pm), approx=approx,
                   rerank=rerank, query_chunk=128)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    assert pm[ti.numpy()].all()


def test_nearest_neighbor():
    from ssf_slam_tpu.ops.knn import nearest_neighbor as j_nn
    from ssf_slam_tpu_torch.ops.knn import nearest_neighbor as t_nn

    rng = np.random.default_rng(14)
    q, p = _lidar(rng, 500), _lidar(rng, 900)
    pm = rng.uniform(size=900) < 0.5
    jd, ji = j_nn(jnp.asarray(q), jnp.asarray(p), jnp.asarray(pm),
                  approx=True)
    td, ti = t_nn(_t(q), _t(p), _t(pm), approx=True)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)


@pytest.mark.parametrize("leaf", [0.2, 1.0])
def test_voxel_downsample(leaf):
    from ssf_slam_tpu.ops.voxel import voxel_downsample as j_vox
    from ssf_slam_tpu_torch.ops.voxel import voxel_downsample as t_vox

    rng = np.random.default_rng(15)
    pts = _lidar(rng, 2048)
    pts[:8] = [-3e8, 3e8, 1e8]  # hash products far past int32
    mask = rng.uniform(size=2048) < 0.9
    jp, jm = j_vox(jnp.asarray(pts), leaf, jnp.asarray(mask))
    tp, tm = t_vox(_t(pts), leaf, _t(mask))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-6,
                               rtol=1e-6)


def test_voxel_hash_wraps_like_xla():
    from ssf_slam_tpu.ops.voxel import _voxel_hash as j_hash
    from ssf_slam_tpu_torch.ops.voxel import _voxel_hash as t_hash

    rng = np.random.default_rng(16)
    c = rng.integers(-2 ** 31, 2 ** 31, size=(4096, 3), dtype=np.int64)
    c = c.astype(np.int32)
    c[0] = [0, 0, 0]
    for size in (8192, 1000):
        np.testing.assert_array_equal(t_hash(_t(c), size).numpy(),
                                      np.asarray(j_hash(jnp.asarray(c),
                                                        size)))


def test_eig3_closed_form():
    from ssf_slam_tpu.ops.eig3 import smallest_eigvec_sym3 as j_eig
    from ssf_slam_tpu_torch.ops.eig3 import smallest_eigvec_sym3 as t_eig

    rng = np.random.default_rng(17)
    a = rng.normal(size=(512, 3, 5)).astype(np.float32)
    a = a @ a.transpose(0, 2, 1) / 5
    a[0] = np.eye(3) * 2.0  # scalar matrix: e_z
    je, jv = j_eig(jnp.asarray(a))
    te, tv = t_eig(_t(a))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-4)


@pytest.mark.parametrize("seed,voxel", [(0, False), (3, False), (0, True)])
def test_plane_features(seed, voxel):
    from ssf_slam_tpu.config import FeatureConfig as JFC
    from ssf_slam_tpu.config import LidarConfig as JLC
    from ssf_slam_tpu.frontend.features import extract_plane_features as jf
    from ssf_slam_tpu_torch.config import FeatureConfig, LidarConfig
    from ssf_slam_tpu_torch.frontend.features import (
        extract_plane_features as tf,
    )

    pts, mask = _street_scan(seed)
    j = jf(jnp.asarray(pts), jnp.asarray(mask), JLC(), JFC(),
           apply_voxel=voxel)
    t = tf(_t(pts), _t(mask), LidarConfig(), FeatureConfig(),
           apply_voxel=voxel)
    assert int(t.mask.sum()) > 200
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_array_equal(t.ring.numpy(), np.asarray(j.ring))
    np.testing.assert_allclose(t.xyz.numpy(), np.asarray(j.xyz), atol=1e-6)


def test_trim_static_mask():
    from ssf_slam_tpu.odometry.egomotion import trim_static_mask as j_trim
    from ssf_slam_tpu_torch.odometry.egomotion import (
        trim_static_mask as t_trim,
    )

    rng = np.random.default_rng(18)
    pts = _lidar(rng, 4096)
    flow = rng.normal(0, 0.1, (4096, 3)).astype(np.float32)
    static = rng.uniform(size=4096) < 0.8
    q = _rand_quat(rng) * np.array([0.01, 0.01, 0.1, 1], np.float32)
    q /= np.linalg.norm(q)
    t = np.array([0.05, -0.02, 0.0], np.float32)
    j = j_trim(*map(jnp.asarray, (pts, flow, static, q, t)), 0.15)
    tt = t_trim(*map(_t, (pts, flow, static, q, t)), 0.15)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(j))
    assert 0 < tt.sum() < static.sum()


def test_fit_local_planes():
    from ssf_slam_tpu.odometry.scan2map import fit_local_planes as j_fit
    from ssf_slam_tpu_torch.odometry.scan2map import (
        fit_local_planes as t_fit,
    )

    pts, mask = _street_scan(1, n=4096)
    pts, mask = pts[::4], mask[::4]
    j = j_fit(jnp.asarray(pts), jnp.asarray(mask))
    t = t_fit(_t(pts), _t(mask))
    assert int(t.valid.sum()) > 100
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    v = t.valid.numpy()
    np.testing.assert_allclose(t.normal.numpy()[v], np.asarray(j.normal)[v],
                               atol=1e-4)


def _icp_scene(rng):
    a = rng.uniform([-10, -10, 0], [10, 10, 0.01], (800, 3))
    b = rng.uniform([-10, -0.01, 0], [10, 0.01, 8], (500, 3))
    c = rng.uniform([-0.01, -10, 0], [0.01, 10, 8], (500, 3))
    tgt = np.concatenate([a, b, c]).astype(np.float32)
    yaw = 0.05
    cz, sz = np.cos(yaw), np.sin(yaw)
    r_true = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]], np.float32)
    t_true = np.array([0.4, -0.3, 0.1], np.float32)
    src = ((tgt - t_true) @ r_true).astype(np.float32)
    return src, tgt


def test_icp_point_to_point():
    from ssf_slam_tpu.ops.icp import icp_point_to_point as j_icp
    from ssf_slam_tpu_torch.ops.icp import icp_point_to_point as t_icp

    rng = np.random.default_rng(19)
    src, tgt = _icp_scene(rng)
    sm = np.ones(len(src), bool)
    tm = rng.uniform(size=len(tgt)) < 0.95
    jr, jt, jf = j_icp(*map(jnp.asarray, (src, tgt, sm, tm)),
                       max_corr_dist=5.0, iters=12)
    tr, tt, tf = t_icp(*map(_t, (src, tgt, sm, tm)), max_corr_dist=5.0,
                       iters=12)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    np.testing.assert_allclose(tf.item(), float(jf), rtol=1e-4, atol=1e-7)


def _graph_problem(rng, k=24, n_active=18):
    """A drifted chain with two loop factors pulling it back."""
    from ssf_slam_tpu.ops.se3 import pose_between, pose_compose

    steps = [(np.array([0, 0, 0.03 * np.sin(i), 1.0], np.float32),
              np.array([1.0, 0.1 * np.cos(i), 0.0], np.float32))
             for i in range(k)]
    q = [np.array([0, 0, 0, 1], np.float32)]
    t = [np.zeros(3, np.float32)]
    for i in range(1, k):
        sq = steps[i][0] / np.linalg.norm(steps[i][0])
        nq, nt = pose_compose((jnp.asarray(q[-1]), jnp.asarray(t[-1])),
                              (jnp.asarray(sq), jnp.asarray(steps[i][1])))
        q.append(np.asarray(nq))
        t.append(np.asarray(nt))
    q, t = np.stack(q), np.stack(t)
    rel_q, rel_t = pose_between((jnp.asarray(np.roll(q, 1, 0)),
                                 jnp.asarray(np.roll(t, 1, 0))),
                                (jnp.asarray(q), jnp.asarray(t)))
    rel_q, rel_t = np.asarray(rel_q).copy(), np.asarray(rel_t).copy()
    rel_q[0], rel_t[0] = [0, 0, 0, 1], 0
    # drift the estimate: the chain bends, the factors do not
    t_est = t + rng.normal(0, 0.05, t.shape).astype(np.float32) \
        * np.arange(k)[:, None] / k
    active = np.arange(k) < n_active
    loop_a = np.array([n_active - 1, n_active - 2, 0, 0], np.int32)
    loop_b = np.array([2, 1, 0, 0], np.int32)
    lq, lt = pose_between((jnp.asarray(q[loop_a]), jnp.asarray(t[loop_a])),
                          (jnp.asarray(q[loop_b]), jnp.asarray(t[loop_b])))
    loop_w = np.array([5.0, 2.0, 0, 0], np.float32)
    return (q.astype(np.float32), t_est.astype(np.float32), active,
            rel_q.astype(np.float32), rel_t.astype(np.float32), loop_a,
            loop_b, np.asarray(lq), np.asarray(lt), loop_w)


def test_solve_pose_graph():
    from ssf_slam_tpu.mapping.posegraph import solve_pose_graph as j_solve
    from ssf_slam_tpu_torch.mapping.posegraph import (
        solve_pose_graph as t_solve,
    )

    args = _graph_problem(np.random.default_rng(20))
    jq, jt = j_solve(*map(jnp.asarray, args), iters=4)
    tq, tt = t_solve(*map(_t, args), iters=4)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    # the solve moved the drifted chain
    assert np.abs(tt.numpy() - args[1]).max() > 1e-3


def _square_loop():
    """tests/test_mapping.py's miniature 40 m square loop with per-step
    odometry drift; the keyframe clouds are the world seen from the true
    pose."""
    rng = np.random.default_rng(1)
    a = rng.uniform([-15, -15, -0.05], [15, 15, 0.05], (400, 3))
    b = rng.uniform([-15, 14.9, 0], [15, 15.1, 6], (300, 3))
    c = rng.uniform([14.9, -15, 0], [15.1, 15, 6], (300, 3))
    world = np.concatenate([a, b, c]).astype(np.float32)
    waypoints = []
    for s, d in (((0, 0), (2, 0)), ((10, 0), (0, 2)), ((10, 10), (-2, 0)),
                 ((0, 10), (0, -2))):
        for i in range(5):
            waypoints.append(np.array([s[0] + d[0] * i, s[1] + d[1] * i,
                                       0.0]))
    waypoints.append(np.zeros(3))
    drift = np.array([0.04, -0.03, 0.0], np.float32)
    return world, [(w.astype(np.float32),
                    (w.astype(np.float32) + drift * k).astype(np.float32))
                   for k, w in enumerate(waypoints)]


def _square_loop_both(**gates):
    """Drive the JAX and the port's mapping_step over ``_square_loop``,
    holding them together at every step; returns (port state, path)."""
    from ssf_slam_tpu.config import MappingConfig as JMC
    from ssf_slam_tpu.mapping import init_map_state as j_init
    from ssf_slam_tpu.mapping import mapping_step as j_step
    from ssf_slam_tpu_torch.config import MappingConfig
    from ssf_slam_tpu_torch.mapping.keyframes import (
        init_map_state,
        mapping_step,
    )

    world, path = _square_loop()
    jcfg, tcfg = JMC(**gates), MappingConfig(**gates)
    js = j_init(jcfg.max_keyframes, len(world))
    ts = init_map_state(tcfg.max_keyframes, len(world), device="cpu")
    mask = np.ones(len(world), bool)
    qid = np.array([0, 0, 0, 1], np.float32)
    for k, (true_t, odom_t) in enumerate(path):
        cloud = world - true_t
        js, jo = j_step(js, jnp.asarray(qid), jnp.asarray(odom_t),
                        jnp.asarray(cloud), jnp.asarray(mask),
                        jnp.float32(k), jcfg)
        ts, to = mapping_step(ts, _t(qid), _t(odom_t), _t(cloud), _t(mask),
                              float(k), tcfg)
        assert to["is_keyframe"] == bool(jo["is_keyframe"]), k
        assert ts.n_kf == int(js.n_kf) and ts.n_loops == int(js.n_loops), k
        for name in ("kf_q", "kf_t", "cur_q", "cur_t"):
            np.testing.assert_allclose(getattr(ts, name).numpy(),
                                       np.asarray(getattr(js, name)),
                                       atol=1e-4, err_msg=f"{name} @ {k}")
    return ts, path


LOOP_GATES = dict(submap_points=2048, icp_iters=20, loop_submap_halfwidth=3,
                  loop_search_radius=4.0, loop_time_gap=5.0,
                  loop_min_keyframes=4)


def _exact_refine_association(monkeypatch) -> None:
    """Give both packages' scan-to-map refine its 1-NN association by the
    exact distance (``knn(..., rerank=True)``) instead of the expansion
    distance, for one test. At keyframe 11 or 12 of the square loop one
    source row has two map points 1.4e-5 m^2 apart against the
    expansion's 6.1e-5 m^2 rounding, so each host's matmul blocking picks
    one of them; the flip moves the refined pose by 3e-5 m and the loop
    closure at keyframe 18 amplifies it to 3.3e-4 m. With the exact
    distance both packages pick the same point and stay within 1.5e-6 m
    through the loop. The refine's own expansion path is held elsewhere
    (tests/test_torch_slam.py)."""
    import sys as _sys

    from ssf_slam_tpu_torch.mapping import keyframes

    # the JAX refine imports knn when it is traced; the package's
    # ``ops.knn`` attribute is the function, so go through sys.modules
    jmod = _sys.modules["ssf_slam_tpu.ops.knn"]
    for mod in (jmod, keyframes):
        plain = mod.knn

        def exact(*args, _plain=plain, **kw):
            return _plain(*args, **{**kw, "rerank": True})

        monkeypatch.setattr(mod, "knn", exact)


def test_mapping_step_square_loop_matches_jax(monkeypatch):
    import ssf_slam_tpu.ops.knn  # noqa: F401  (sys.modules entry)

    _exact_refine_association(monkeypatch)
    ts, path = _square_loop_both(max_keyframes=32, **LOOP_GATES)
    assert ts.n_loops > 0
    final_err = np.linalg.norm(ts.cur_t.numpy() - path[-1][0])
    assert final_err < 0.5 * np.linalg.norm(path[-1][1] - path[-1][0])


# the keyframe-buffer overflow case: K = 5 slots for the square loop's 21
# keyframes; the gates let the last stored keyframe close its loop again
# after the overflow, so loop factors name nodes past the buffer
OVERFLOW_GATES = dict(LOOP_GATES, max_keyframes=5, loop_search_radius=11.0,
                      loop_time_gap=3.0, loop_skip_after_close=1)
# the JAX run of that case (make_overflow_fixture), which chip_smoke.py
# also holds the port to on the card
OVERFLOW_REF = os.path.join(torch_ref.FIXTURE_DIR,
                            "mapping_overflow_ref.npz")
OVERFLOW_STATE = ("kf_q", "kf_t", "cur_q", "cur_t")


def test_mapping_step_keyframe_overflow_matches_jax():
    """Past max_keyframes the JAX step drops the keyframe writes and reads
    the last row; the port follows it instead of failing. The gates let
    the last stored keyframe close its loop again after the overflow, so
    loop factors name nodes past the buffer."""
    k = OVERFLOW_GATES["max_keyframes"]
    ts, path = _square_loop_both(**OVERFLOW_GATES)
    assert ts.n_kf == len(path) > k
    assert (ts.loop_a[:ts.n_loops] >= k).sum() >= 2, ts.loop_a
    assert all(np.isfinite(getattr(ts, n).numpy()).all()
               for n in OVERFLOW_STATE)


def make_overflow_fixture(path: str = OVERFLOW_REF) -> None:
    """The JAX mapping_step over the overflow case: its inputs (the world
    cloud, the true and the odometry positions, the gates as JSON) and, at
    every step, the keyframe flag, n_kf, n_loops and OVERFLOW_STATE; the
    final loop slots."""
    import json

    from ssf_slam_tpu.config import MappingConfig as JMC
    from ssf_slam_tpu.mapping import init_map_state as j_init
    from ssf_slam_tpu.mapping import mapping_step as j_step

    world, path_ = _square_loop()
    cfg = JMC(**OVERFLOW_GATES)
    js = j_init(cfg.max_keyframes, len(world))
    mask = np.ones(len(world), bool)
    qid = np.array([0, 0, 0, 1], np.float32)
    steps = {n: [] for n in ("is_keyframe", "n_kf", "n_loops")
             + OVERFLOW_STATE}
    for k, (true_t, odom_t) in enumerate(path_):
        js, jo = j_step(js, jnp.asarray(qid), jnp.asarray(odom_t),
                        jnp.asarray(world - true_t), jnp.asarray(mask),
                        jnp.float32(k), cfg)
        steps["is_keyframe"].append(bool(jo["is_keyframe"]))
        steps["n_kf"].append(int(js.n_kf))
        steps["n_loops"].append(int(js.n_loops))
        for n in OVERFLOW_STATE:
            steps[n].append(np.asarray(getattr(js, n)))
    np.savez_compressed(
        path, world=world, true_t=np.stack([p[0] for p in path_]),
        odom_t=np.stack([p[1] for p in path_]),
        gates=np.array(json.dumps(OVERFLOW_GATES)),
        loop_a=np.asarray(js.loop_a), loop_b=np.asarray(js.loop_b),
        **{n: np.stack(v) for n, v in steps.items()})


def test_mapping_step_keyframe_overflow_matches_fixture():
    """The port's mapping_step over the committed JAX run of the overflow
    case (chip_smoke.py's phase 6b holds the card to the same file): the
    keyframe flags, n_kf and n_loops equal and OVERFLOW_STATE within 1e-4
    at every step, the final loop slots equal."""
    import json

    from ssf_slam_tpu_torch.config import MappingConfig
    from ssf_slam_tpu_torch.mapping.keyframes import (
        init_map_state,
        mapping_step,
    )

    with np.load(OVERFLOW_REF) as z:
        ref = {n: z[n] for n in z.files}
    gates = json.loads(str(ref["gates"]))
    assert gates == OVERFLOW_GATES
    cfg = MappingConfig(**gates)
    world = ref["world"]
    ts = init_map_state(cfg.max_keyframes, len(world), device="cpu")
    mask = torch.ones(len(world), dtype=torch.bool)
    qid = torch.tensor([0.0, 0.0, 0.0, 1.0])
    for k in range(len(ref["odom_t"])):
        ts, to = mapping_step(ts, qid, _t(ref["odom_t"][k]),
                              _t(world - ref["true_t"][k]), mask, float(k),
                              cfg)
        assert to["is_keyframe"] == bool(ref["is_keyframe"][k]), k
        assert ts.n_kf == ref["n_kf"][k] and ts.n_loops == ref["n_loops"][k]
        for n in OVERFLOW_STATE:
            np.testing.assert_allclose(getattr(ts, n).numpy(), ref[n][k],
                                       atol=1e-4, err_msg=f"{n} @ {k}")
    assert ts.n_kf > cfg.max_keyframes
    np.testing.assert_array_equal(ts.loop_a.numpy(), ref["loop_a"])
    np.testing.assert_array_equal(ts.loop_b.numpy(), ref["loop_b"])


if __name__ == "__main__":
    if sys.argv[1:] != ["--make-fixture"]:
        sys.exit("usage: python tests/test_torch_mapping.py --make-fixture")
    import jax

    jax.config.update("jax_platforms", "cpu")
    make_overflow_fixture()
