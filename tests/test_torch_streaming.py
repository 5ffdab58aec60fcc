"""The port's streaming runner (engine/streaming.py) on the CPU.

- Stream against batch under one box: ``StreamingRunner`` over 4 frames
  (the small TFlow with the committed weights, f32, banded, the small SLAM
  step) at pipeline depth 1 and 2, against ``run_sequence_fused`` given
  the runner's anchored box: the TUM file the runner writes as poses
  retire is byte for byte ``write_tum`` of the batch run's poses (TUM
  order t x y z qx qy qz qw), and the final states agree. The ssfc flavour
  (the SegNet classifier's mask) runs the same way.
- ``box_overshoot`` against the JAX package's, and the one-time warning
  when scans leave the anchored box.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ref  # noqa: E402
from test_torch_segnet import SEG_NPZ  # noqa: E402
from test_torch_variants import SMALL_STEP, _configs  # noqa: E402

torch.set_num_threads(1)

N, N_FRAMES = 1024, 4


@pytest.fixture(autouse=True)
def _xla_cpu_knn(monkeypatch):
    torch_ref.round_knn_like_xla_cpu(monkeypatch)


@pytest.fixture(scope="module")
def frames():
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    return generate_sequence(n_frames=N_FRAMES, n_points=N, seed=0,
                             noise=0.004, n_moving=4)


@pytest.fixture(scope="module")
def model():
    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.weights import load_tflow

    return load_tflow(FlowNetConfig(**torch_ref.SMALL_NET), device="cpu")


def _stream(model, frames, tum, depth, seg=None, margin=100.0):
    from ssf_slam_tpu_torch.engine.streaming import StreamingRunner

    runner = StreamingRunner(model, _configs(N, "SSF", False, SMALL_STEP)[1],
                             seg_apply=seg, tum_path=str(tum),
                             pipeline_depth=depth, device="cpu",
                             box_margin=margin)
    return runner, runner.run(iter(frames))


@pytest.mark.parametrize("depth,flavour", [(1, "ssf"), (2, "ssf"),
                                           (2, "ssfc")])
def test_stream_matches_batch_under_one_box(model, frames, tmp_path, depth,
                                            flavour):
    from ssf_slam_tpu_torch.engine.evaluation import write_tum
    from ssf_slam_tpu_torch.engine.fused import run_sequence_fused
    from ssf_slam_tpu_torch.weights import load_segnet

    seg = (load_segnet(SEG_NPZ, dtype="float32", device="cpu")
           if flavour == "ssfc" else None)
    runner, stats = _stream(model, frames, tmp_path / "s.tum", depth, seg)
    assert stats["n_scans"] == N_FRAMES
    assert stats["pipeline_depth"] == depth
    for key in ("hz", "latency_ms_mean", "latency_ms_p95",
                "dispatch_ms_mean", "dispatch_ms_p95"):
        assert np.isfinite(stats[key]) and stats[key] > 0, key
    assert stats["latency_ms_p95"] >= stats["latency_ms_mean"] * 0.5
    cfg = _configs(N, "SSF", False, SMALL_STEP)[1]
    state, want = run_sequence_fused(model, frames, cfg, device="cpu",
                                     box=runner.box, seg_apply=seg,
                                     return_state=True)
    write_tum(str(tmp_path / "b.tum"), [f["time"] for f in frames],
              want["pose_t"], want["pose_q"])
    assert ((tmp_path / "s.tum").read_bytes()
            == (tmp_path / "b.tum").read_bytes())
    got = runner.final_state
    assert got.map_state.n_kf == state.map_state.n_kf
    torch.testing.assert_close(got.odom_t, state.odom_t, rtol=0, atol=0)
    torch.testing.assert_close(got.map_state.kf_t, state.map_state.kf_t,
                               rtol=0, atol=0)


def test_box_overshoot_matches_jax():
    from ssf_slam_tpu.engine.streaming import box_overshoot as jover
    from ssf_slam_tpu_torch.engine.fused import sequence_box
    from ssf_slam_tpu_torch.engine.streaming import box_overshoot

    rng = np.random.default_rng(0)
    anchor = rng.uniform(-20, 20, (256, 3)).astype(np.float32)
    box = sequence_box(np.concatenate([anchor - 2.0, anchor + 2.0]))
    jbox = tuple(b.numpy() for b in box)
    for shift in (0.0, 3.0, 30.0):
        pts = anchor + np.float32(shift)
        mask = rng.uniform(size=256) < 0.7
        want = jover(pts, mask, jbox)
        assert box_overshoot(pts, mask, box) == want
        assert box_overshoot(pts, mask, jbox) == want
    assert box_overshoot(anchor, np.zeros(256, bool), box) == 0.0
    assert box_overshoot(anchor + 30.0, np.ones(256, bool), box) > 20.0


def test_stream_warns_once_outside_the_box(model, frames, tmp_path,
                                           capsys):
    """Scans 1 and 2 lifted 120 m, out of the cubic box anchored at the
    first scan (its side is the scan's widest extent, ~106 m, plus the
    margins): the runner says so once, with the overshoot."""
    from ssf_slam_tpu_torch.engine.streaming import box_overshoot

    moved = [frames[0]] + [dict(f, pos1=f["pos1"] + np.float32([0, 0, 120]))
                           for f in frames[1:3]]
    runner, _ = _stream(model, moved, tmp_path / "w.tum", 1, margin=1.0)
    over = box_overshoot(moved[1]["pos1"], moved[1]["mask1"], runner.box)
    assert over > 10.0
    err = capsys.readouterr().err
    assert err.count("outside the anchored Morton box") == 1
    assert f"drifted {over:.1f} m" in err and "box_margin=1 m" in err
