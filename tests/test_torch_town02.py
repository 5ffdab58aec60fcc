"""Town02 data and its entry points (``ssf_slam_tpu_torch/data/
{sceneflow_gen,town02,make_town02_seq}.py``, ``engine/eval_town02.py``,
``train/train_ssf.py``'s Town02 flags) against the JAX package, on the CPU.

The recorded Town02 map is not in the repository, so both packages'
``MAP_BIN`` point at a generated planar map inside JAX's extent (x in
[-9, 195], y in [-308, -103], z = -2.5: streets 8 m wide every 40 m):

- ``sceneflow_gen``'s functions, ``sensor_track``, ``vehicle_tracks``,
  ``map_structures``, ``make_frames`` (with and without vehicles and
  structures) and ``training_frames``: byte-identical to JAX's;
- ``make_town02_seq`` writes the arrays and the ``poses.tum`` of
  scripts/make_town02_seq.py;
- ``eval_town02`` runs on the CPU and reports the JAX script's keys;
- ``train_ssf --town02-routes 1 --best-on t2`` runs an epoch on the CPU
  and refuses ``--best-on t2`` without routes.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ref  # noqa: E402

torch.set_num_threads(1)


def write_planar_map(path: str, seed: int = 0,
                     spacing: float = 0.5) -> int:
    """A KITTI .bin (x, y, z, intensity float32 rows) of streets 8 m wide
    every 40 m over JAX's Town02 extent, z = -2.5; returns the row
    count."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(-9.0, 195.0, spacing),
                         np.arange(-308.0, -103.0, spacing), indexing="ij")
    road = ((np.abs((gx + 9.0) % 40.0 - 20.0) < 4.0)
            | (np.abs((gy + 308.0) % 40.0 - 20.0) < 4.0))
    x = gx[road] + rng.uniform(-0.1, 0.1, road.sum())
    y = gy[road] + rng.uniform(-0.1, 0.1, road.sum())
    rows = np.stack([x, y, np.full_like(x, -2.5), rng.uniform(0, 1, x.size)],
                    1).astype(np.float32)
    rows.tofile(path)
    return len(rows)


@pytest.fixture
def planar_map(tmp_path, monkeypatch):
    """Both packages' MAP_BIN on one generated map."""
    from ssf_slam_tpu.data import town02 as jt
    from ssf_slam_tpu_torch.data import town02 as tt

    path = str(tmp_path / "town02-planar.bin")
    assert write_planar_map(path) > 10000
    monkeypatch.setattr(jt, "MAP_BIN", path)
    monkeypatch.setattr(tt, "MAP_BIN", path)
    return path


def _assert_frames_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_sceneflow_gen_matches_jax():
    from ssf_slam_tpu.data import sceneflow_gen as js
    from ssf_slam_tpu_torch.data import sceneflow_gen as ts

    rng = np.random.default_rng(3)
    pts1 = rng.uniform(-20, 20, (600, 3)).astype(np.float32)
    pts2 = pts1 + np.array([0.8, 0.1, 0.0], np.float32)
    r1, r2 = js._yaw_mat(0.1), js._yaw_mat(0.13)
    t1, t2 = np.array([1.0, 2.0, 0.0]), np.array([1.9, 2.2, 0.0])
    objs = [(m.ObjectTrack(center1=np.array([5.0, 3.0, 0.0]),
                           size=np.array([4.0, 2.0, 2.0]), yaw1=0.2,
                           center2=np.array([5.6, 3.1, 0.0]), yaw2=0.25))
            for m in (js, ts)]
    np.testing.assert_array_equal(ts.ego_flow(pts1, r1, t1, r2, t2),
                                  js.ego_flow(pts1, r1, t1, r2, t2))
    np.testing.assert_array_equal(ts.points_in_box(pts1, objs[1]),
                                  js.points_in_box(pts1, objs[0]))
    for g, w in zip(ts.compute_pairwise_scene_flow(pts1, r1, t1, r2, t2,
                                                   [objs[1]]),
                    js.compute_pairwise_scene_flow(pts1, r1, t1, r2, t2,
                                                   [objs[0]])):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(ts.coarse_bev_flow(pts1, pts2),
                                  js.coarse_bev_flow(pts1, pts2))


def test_routes_vehicles_and_structures_match_jax(planar_map):
    from ssf_slam_tpu.data import town02 as jt
    from ssf_slam_tpu_torch.data import town02 as tt

    for route_seed in (None, 5):
        for (pg, yg), (pw, yw) in zip(tt.sensor_track(12, route_seed),
                                      jt.sensor_track(12, route_seed)):
            np.testing.assert_array_equal(pg, pw)
            assert yg == yw
    for g, w in zip(tt.vehicle_tracks(8, 3, seed=2),
                    jt.vehicle_tracks(8, 3, seed=2)):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    facades = tt.map_structures(seed=1)
    assert len(facades) > 1000
    np.testing.assert_array_equal(facades, jt.map_structures(seed=1))


@pytest.mark.parametrize("n_vehicles,structures", [(0, False), (4, True)])
def test_make_frames_match_jax(planar_map, n_vehicles, structures):
    from ssf_slam_tpu.data import town02 as jt
    from ssf_slam_tpu_torch.data import town02 as tt

    kw = dict(n_vehicles=n_vehicles, seed=3, structures=structures)
    got, gposes = tt.make_frames(4, **kw)
    want, wposes = jt.make_frames(4, **kw)
    _assert_frames_equal(got, want)
    for (pg, yg), (pw, yw) in zip(gposes, wposes):
        np.testing.assert_array_equal(pg, pw)
        assert yg == yw
    if n_vehicles:
        assert sum(f["s_fg_mask"].sum() for f in got) > 0


def test_training_frames_match_jax(planar_map):
    from ssf_slam_tpu.data import town02 as jt
    from ssf_slam_tpu_torch.data import town02 as tt

    kw = dict(n_points=2048, n_vehicles=2, seed_base=4, fg_oversample=256)
    got = tt.training_frames(2, 2, **kw)
    _assert_frames_equal(got, jt.training_frames(2, 2, **kw))
    assert {f["pos1"].shape for f in got} == {(2048, 3)}


def test_make_town02_seq_writes_the_scripts_files(planar_map, tmp_path,
                                                  monkeypatch):
    from ssf_slam_tpu_torch.data import make_town02_seq

    spec = importlib.util.spec_from_file_location(
        "jax_make_town02_seq",
        os.path.join(torch_ref.REPO, "scripts", "make_town02_seq.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    argv = ["--frames", "3", "--vehicles", "2", "--seed", "1",
            "--structures"]
    monkeypatch.setattr(sys, "argv", ["make_town02_seq.py", "--out",
                                      str(tmp_path / "jax"), *argv])
    assert script.main() == 0
    assert make_town02_seq.main(["--out", str(tmp_path / "port"),
                                 *argv]) == 0
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port"))
    assert names == ["000000.npz", "000001.npz", "000002.npz", "poses.tum"]
    with open(tmp_path / "jax" / "poses.tum", "rb") as a, \
            open(tmp_path / "port" / "poses.tum", "rb") as b:
        assert a.read() == b.read()
    for name in names[:-1]:
        with np.load(tmp_path / "jax" / name) as w, \
                np.load(tmp_path / "port" / name) as g:
            assert sorted(w.files) == sorted(g.files)
            for k in w.files:
                np.testing.assert_array_equal(g[k], w[k])


def test_eval_town02_reports_the_scripts_keys(planar_map, tmp_path):
    """The fused SSF path over a short mover sequence at 1024 points in
    float32 with the committed weights: finite metrics under the JAX
    script's keys."""
    import jax.numpy as jnp

    from ssf_slam_tpu.models.metrics import flow_metrics, seg_metrics
    from ssf_slam_tpu_torch.engine import eval_town02

    out = tmp_path / "t2.json"
    assert eval_town02.main([
        "--ckpt", torch_ref.WEIGHTS_NPZ, "--frames", "3", "--vehicles", "2",
        "--n-points", "1024", "--net-dtype", "float32", "--structures",
        "--device", "cpu", "--out-json", str(out)]) == 0
    got = json.loads(out.read_text())
    z = jnp.zeros((1, 8))
    keys = (set(flow_metrics(jnp.zeros((1, 8, 3)), jnp.zeros((1, 8, 3)), z))
            | set(seg_metrics(z, z, z))
            | {"ate_m", "n_frames", "n_vehicles", "n_loops"})
    assert set(got) == keys
    assert all(np.isfinite(v) for v in got.values())
    assert (got["n_frames"], got["n_vehicles"]) == (3, 2)


def test_train_ssf_town02_mix_runs(planar_map, tmp_path, monkeypatch):
    from ssf_slam_tpu_torch.train import train_ssf

    monkeypatch.setattr(train_ssf, "N_POINTS", 1024)
    out = tmp_path / "run"
    common = ["--epochs", "1", "--n-worlds", "1", "--frames-per-world", "2",
              "--batch-size", "2", "--neighbor-backend", "xla",
              "--device", "cpu", "--out", str(out)]
    with pytest.raises(SystemExit):
        train_ssf.main(["--best-on", "t2", *common])
    assert train_ssf.main(["--town02-routes", "1", "--town02-frames", "2",
                           "--best-on", "t2", *common]) == 0
    rec = json.loads((out / "metrics.jsonl").read_text().splitlines()[-1])
    assert {"t2_epe3d", "t2_iou_moving", "epe3d"} <= set(rec)
    assert np.isfinite(rec["t2_epe3d"])
    assert (out / "best.npz").exists() and (out / "last.npz").exists()
