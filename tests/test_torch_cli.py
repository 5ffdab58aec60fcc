"""The port's command line (``python -m ssf_slam_tpu_torch.cli``), its data
readers, the ssfb loader and the map export, on the CPU (``--device cpu``).

- ``run --variant seg`` for 3 frames, ``evaluate --variants noseg`` (the
  TUM and KITTI files and the table, as the JAX package's
  ``test_cli_evaluate_smoke``), ``run`` from an ssfb file;
- ssfc, sf and ``--stream`` with random-weight npz files written here (the
  TUM file equal to the in-process fused run's; a 4-channel checkpoint
  serving sf; a 3-channel one refused for ssf with the JAX CLI's message);
- ``train`` for one epoch (one step, one eval batch), then ``eval-flow``
  on the ``best.npz`` it wrote;
- without ``--device cpu`` on a host with no CUDA, the CLI raises;
- the carla, ft3d (HPLFlowNet) and kitti (FlowNet3D) readers against the
  JAX package's readers on files written here (equal arrays);
- the ssfb loader built from ``native/loader.cc`` into the port's build
  directory, against the frames written;
- ``map_to_ply`` bytes against the JAX package's for one map state.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

CPU = ["--device", "cpu"]
N_NET = 2048  # the smallest cloud of the default TFlow (sa1 takes 2048)


def _main(argv):
    from ssf_slam_tpu_torch.cli import main

    return main(argv + CPU)


def _read_tum(path):
    from ssf_slam_tpu_torch.engine.evaluation import read_tum

    return read_tum(str(path))


def test_cli_run_seg(tmp_path, capsys):
    out = tmp_path / "t.tum"
    assert _main(["run", "--variant", "seg", "--synthetic", "--frames", "3",
                  "--out", str(out), "--map-ply",
                  str(tmp_path / "m.ply")]) == 0
    t, p, q = _read_tum(out)
    assert len(t) == 3 and np.isfinite(p).all()
    text = capsys.readouterr().out
    assert "ATE RMSE vs ground truth" in text and "map points" in text
    assert (tmp_path / "m.ply").read_bytes().startswith(b"ply\n")


def test_cli_evaluate_noseg(tmp_path, capsys):
    from ssf_slam_tpu_torch.utils.poses import read_kitti_poses

    out_dir = str(tmp_path / "res")
    assert _main(["evaluate", "--synthetic", "--frames", "3",
                  "--variants", "noseg", "--out-dir", out_dir]) == 0
    for name in ("00_SEG.tum", "00_SEG.kitti", "00_NOSEG.tum",
                 "00_NOSEG.kitti"):
        assert os.path.exists(os.path.join(out_dir, name)), name
    table = capsys.readouterr().out
    assert "| variant |" in table and "| noseg |" in table
    assert "| seg | (reference) |" in table and "ATE vs GT (m)" in table
    mats = read_kitti_poses(os.path.join(out_dir, "00_NOSEG.kitti"))
    assert mats.shape in ((3, 3, 4), (3, 4, 4))


def test_cli_needs_cuda_or_cpu_flag(tmp_path):
    from ssf_slam_tpu_torch.cli import main

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["run", "--variant", "seg", "--synthetic", "--frames", "2",
              "--out", str(tmp_path / "t.tum")])


@pytest.fixture(scope="module")
def random_npz(tmp_path_factory):
    """Random-weight npz files (Flax's initialisers, seeded): a joint
    TFlow, a flow-only TFlow and a SegNet."""
    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.models.layers import init_flax
    from ssf_slam_tpu_torch.models.segnet import SegNet
    from ssf_slam_tpu_torch.models.tflow import TFlow
    from ssf_slam_tpu_torch.weights import save_npz, to_flax

    d = tmp_path_factory.mktemp("npz")
    paths = {}
    for name, model in (
            ("joint", TFlow(FlowNetConfig(npoint=N_NET, joint_seg=True))),
            ("flow", TFlow(FlowNetConfig(npoint=N_NET))),
            ("seg", SegNet())):
        init_flax(model, torch.Generator().manual_seed(len(paths) + 1))
        paths[name] = str(d / f"{name}.npz")
        save_npz(paths[name], to_flax(model))
    return paths


def _net_args(random_npz, frames=2):
    return ["--synthetic", "--frames", str(frames), "--n-points",
            str(N_NET), "--net-dtype", "float32", "--ckpt",
            random_npz["joint"]]


def test_cli_ssfc_equals_the_fused_run(tmp_path, random_npz):
    from ssf_slam_tpu_torch.config import FlowNetConfig, PipelineConfig
    from ssf_slam_tpu_torch.config import Variant
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence
    from ssf_slam_tpu_torch.engine.fused import run_sequence_fused
    from ssf_slam_tpu_torch.weights import load_segnet, load_tflow

    out = tmp_path / "c.tum"
    assert _main(["run", "--variant", "ssfc", *_net_args(random_npz),
                  "--seg-ckpt", random_npz["seg"], "--out", str(out)]) == 0
    frames = generate_sequence(n_frames=2, n_points=N_NET, seed=0,
                               noise=0.004, n_moving=4)
    model = load_tflow(FlowNetConfig(npoint=N_NET, joint_seg=True,
                                     neighbor_backend="banded"),
                       path=random_npz["joint"], device="cpu")
    seg = load_segnet(random_npz["seg"], dtype="bfloat16", device="cpu")
    want = run_sequence_fused(model, frames, PipelineConfig(Variant.SSF),
                              device="cpu", seg_apply=seg)
    _, p, q = _read_tum(out)
    np.testing.assert_allclose(p, want["pose_t"], atol=1e-6)
    np.testing.assert_allclose(q, want["pose_q"], atol=1e-6)


def test_cli_checkpoint_heads(tmp_path, random_npz, capsys):
    """A joint (4-channel) checkpoint serves sf; a flow-only one does not
    fit ssf's joint head, and the CLI says so as the JAX CLI does."""
    assert _main(["run", "--variant", "sf", *_net_args(random_npz),
                  "--out", str(tmp_path / "sf.tum")]) == 0
    assert len(_read_tum(tmp_path / "sf.tum")[0]) == 2
    args = _net_args(random_npz)
    args[args.index("--ckpt") + 1] = random_npz["flow"]
    with pytest.raises(ValueError, match=r"does not fit the model "
                       r"\(npoint=2048\): first mismatch template\(4, "):
        _main(["run", "--variant", "ssf", *args,
               "--out", str(tmp_path / "x.tum")])


def test_cli_stream(tmp_path, random_npz, capsys):
    out = tmp_path / "s.tum"
    assert _main(["run", "--variant", "ssf", "--stream", "--pipeline-depth",
                  "2", *_net_args(random_npz, 3), "--out", str(out)]) == 0
    text = capsys.readouterr().out
    assert "streamed 3 scans" in text and "completion latency mean" in text
    assert "held mean" in text and "retired early" in text
    assert "10 Hz live target" in text
    assert len(_read_tum(out)[0]) == 3
    assert _main(["run", "--variant", "seg", "--stream", "--synthetic",
                  "--frames", "2", "--out", str(out)]) == 2


def test_cli_train_then_eval_flow(tmp_path, capsys):
    ckpt = tmp_path / "run"
    assert _main(["train", "--variant", "ssf", "--synthetic", "--frames",
                  "2", "--n-points", str(N_NET), "--epochs", "1",
                  "--batch-size", "1", "--ckpt-dir", str(ckpt)]) == 0
    assert "final eval EPE:" in capsys.readouterr().out
    assert (ckpt / "best.npz").exists()
    assert _main(["eval-flow", "--variant", "ssf", "--synthetic", "--frames",
                  "2", "--n-points", str(N_NET), "--net-dtype", "float32",
                  "--neighbor-backend", "xla", "--ckpt", str(ckpt)]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("EPE3D ") and "Outlier" in line
    assert np.isfinite(float(line.split()[1]))


def _frames(n_frames=3, n=512, seed=5):
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    return generate_sequence(n_frames=n_frames, n_points=n, seed=seed,
                             noise=0.004, n_moving=2)


def _assert_items_equal(got, want):
    assert len(got) == len(want)
    for i in range(len(want)):
        a, b = got[i], want[i]
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=f"item {i} {k}")


def test_carla_reader_matches_jax(tmp_path):
    from ssf_slam_tpu.data import carla as jc
    from ssf_slam_tpu_torch.data import carla as tc

    frames = _frames()
    tc.save_sequence_npz(frames, str(tmp_path / "p"))
    jc.save_sequence_npz(frames, str(tmp_path / "j"))
    for a, b in zip(sorted(os.listdir(tmp_path / "p")),
                    sorted(os.listdir(tmp_path / "j"))):
        pa, pb = tc.load_npz_frame(str(tmp_path / "p" / a)), \
            jc.load_npz_frame(str(tmp_path / "j" / b))
        assert sorted(pa) == sorted(pb)
        for k in pb:
            np.testing.assert_array_equal(pa[k], pb[k])
    for kw in (dict(n_points=256), dict(n_points=1024),
               dict(n_points=256, remove_ground=True, filter_movers=True),
               dict(n_points=256, fg_points=64)):
        got = tc.CarlaSceneFlowDataset(str(tmp_path / "p"), seed=3, **kw)
        want = jc.CarlaSceneFlowDataset(str(tmp_path / "p"), seed=3, **kw)
        _assert_items_equal(got, want)
        for a, b in zip(got.batches(2), want.batches(2)):
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])


def test_generic_readers_match_jax(tmp_path):
    from ssf_slam_tpu.data import generic as jg
    from ssf_slam_tpu_torch.data import generic as tg

    frames = _frames(seed=6)
    for i, f in enumerate(frames):  # HPLFlowNet: per-example directories
        d = tmp_path / "hpl" / f"{i:04d}"
        d.mkdir(parents=True)
        np.save(d / "pc1.npy", f["pos1"])
        np.save(d / "pc2.npy", f["pos1"] + f["gt"])
    (tmp_path / "fn3d").mkdir()
    for i, f in enumerate(frames):  # FlowNet3D: both key dialects
        if i % 2:
            np.savez(tmp_path / "fn3d" / f"{i:04d}.npz", points1=f["pos1"],
                     points2=f["pos2"], flow=f["gt"],
                     valid_mask1=f["mask1"], s_fg_mask=f["s_fg_mask"])
        else:
            np.savez(tmp_path / "fn3d" / f"{i:04d}.npz", pos1=f["pos1"],
                     pos2=f["pos2"], gt=f["gt"])
    for kind, root in (("ft3d_hpl", "hpl"), ("kitti_hpl", "hpl"),
                       ("ft3d_fn3d", "fn3d"), ("kitti_fn3d", "fn3d")):
        for n in (256, 1024):
            got = tg.make_dataset(kind, str(tmp_path / root), n_points=n,
                                  seed=2)
            want = jg.make_dataset(kind, str(tmp_path / root), n_points=n,
                                   seed=2)
            assert type(got).__name__ == type(want).__name__
            _assert_items_equal(got, want)


def test_ssfb_loader_builds_in_the_port(tmp_path):
    from ssf_slam_tpu_torch.data import ssfb

    frames = _frames(n_frames=4, n=300)
    ssfb.write_ssfb(frames, str(tmp_path / "s.ssfb"))
    assert ssfb.native_available()
    lib = ssfb.lib_path()
    assert os.path.dirname(lib) == ssfb.BUILD_DIR and os.path.exists(lib)
    seq = ssfb.SsfbSequence(str(tmp_path / "s.ssfb"))
    assert (seq.n_frames, seq.n_points) == (4, 300)
    got = [fr for _, fr in seq.prefetch_iter()]
    assert len(got) == 4
    for g, f in zip(got, frames):
        for k in ("pos1", "pos2", "gt", "ego_flow", "s_fg_mask"):
            np.testing.assert_array_equal(g[k], np.asarray(f[k], np.float32))
        np.testing.assert_array_equal(g["mask1"], f["mask1"].astype(bool))
        assert g["time"] == np.float32(f["time"])
    seq.close()
    stripe = ssfb.SsfbStripe([str(tmp_path / "s.ssfb")] * 2)
    batches = list(stripe.batches())
    assert [k for k, _ in batches] == [0, 1, 2, 3]
    np.testing.assert_array_equal(batches[2][1]["pos1"][1],
                                  frames[2]["pos1"])
    stripe.close()


def test_cli_reads_ssfb(tmp_path):
    from ssf_slam_tpu_torch.data import ssfb

    frames = _frames(n_frames=3, n=8192, seed=0)
    ssfb.write_ssfb(frames, str(tmp_path / "s.ssfb"))
    assert _main(["run", "--variant", "seg", "--dataset",
                  str(tmp_path / "s.ssfb"), "--out",
                  str(tmp_path / "t.tum")]) == 0
    t, p, _ = _read_tum(tmp_path / "t.tum")
    np.testing.assert_allclose(t, [f["time"] for f in frames], atol=1e-6)
    assert np.isfinite(p).all()


def test_map_to_ply_matches_jax(tmp_path):
    """One map state (a SEG run's), exported by both packages: the JAX
    package's ``map_to_ply`` reads it in its layout ([K, 3, F] clouds)."""
    import jax.numpy as jnp

    from ssf_slam_tpu.mapping.keyframes import MapState as JMapState
    from ssf_slam_tpu.utils.viz import map_to_ply as jply
    from ssf_slam_tpu_torch.config import LidarConfig, PipelineConfig
    from ssf_slam_tpu_torch.config import Variant
    from ssf_slam_tpu_torch.engine.pipeline import run_sequence
    from ssf_slam_tpu_torch.utils.viz import map_to_ply

    frames = _frames(n_frames=4, n=1024, seed=7)
    cfg = PipelineConfig(variant=Variant.SEG,
                         lidar=LidarConfig(max_points=1024))
    state, _ = run_sequence(frames, cfg, device="cpu")
    ms = state.map_state
    assert ms.n_kf >= 2
    jms = JMapState(**{
        k: (jnp.asarray(np.swapaxes(v.numpy(), 1, 2))
            if k in ("kf_cloud", "kf_rnorm")
            else jnp.asarray(v.numpy()) if torch.is_tensor(v)
            else jnp.int32(v))
        for k, v in ms._asdict().items()})
    n = map_to_ply(ms, str(tmp_path / "p.ply"), stride=1)
    assert n == jply(jms, str(tmp_path / "j.ply"), stride=1) > 0
    assert (tmp_path / "p.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()
