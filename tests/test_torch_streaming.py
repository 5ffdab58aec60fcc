"""The port's streaming runner (engine/streaming.py) on the CPU.

- Stream against batch under one box: ``StreamingRunner`` over 4 frames
  (the small TFlow with the committed weights, f32, banded, the small SLAM
  step) at pipeline depth 1, 2 and 4, against ``run_sequence_fused`` given
  the runner's anchored box: the TUM file the runner writes as poses
  retire is byte for byte ``write_tum`` of the batch run's poses (TUM
  order t x y z qx qy qz qw), and the final states agree. The ssfc flavour
  (the SegNet classifier's mask) runs the same way. On the CPU a pose's
  copy is done when the step returns, so at depth > 1 every pose is
  retired at once (``retired_early``).
- With each copy made to read as not done (a device behind the host):
  a paced source at depth 2 (a scan due every period, and never before
  the poses of the scans before it are on the host, at most a bounded
  wait, so that a loaded host cannot queue one) has each pose retired
  before the next scan's pickup, every one counted in ``retired_early``;
  with a scan always waiting when a step returns, at depth 2 and 4, each
  pose is retired at the depth bound or in the final drain. The TUM file
  is the batch run's in both.
- The source's thread: it ends with ``run``, and when the source or the
  step raises, ``run`` raises that error and no thread it started is left
  alive. The hand-off alone, under a short switch interval with more
  sources than cores and a consumer that now and then outwaits the
  source's put: every frame once, in order, then the end; a source closed
  early ends too.
- ``box_overshoot`` against the JAX package's, and the one-time warning
  when scans leave the anchored box.
"""

from __future__ import annotations

import os
import sys
import threading
import time

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


def _batch_tum(model, frames, box, path, seg=None):
    """``write_tum`` of ``run_sequence_fused``'s poses under ``box``;
    returns its final state."""
    from ssf_slam_tpu_torch.engine.evaluation import write_tum
    from ssf_slam_tpu_torch.engine.fused import run_sequence_fused

    cfg = _configs(N, "SSF", False, SMALL_STEP)[1]
    state, want = run_sequence_fused(model, frames, cfg, device="cpu",
                                     box=box, seg_apply=seg,
                                     return_state=True)
    write_tum(str(path), [f["time"] for f in frames], want["pose_t"],
              want["pose_q"])
    return state


@pytest.fixture
def sources(monkeypatch):
    """Every ``_FrameSource`` the runner starts during the test."""
    import ssf_slam_tpu_torch.engine.streaming as streaming

    started = []

    class Kept(streaming._FrameSource):
        def __init__(self, it):
            super().__init__(it)
            started.append(self)

    monkeypatch.setattr(streaming, "_FrameSource", Kept)
    return started


@pytest.fixture
def copies_in_flight(monkeypatch):
    """Every readback's copy reads as not done yet, as on a card whose
    device runs behind the host: only the depth bound and a runner with
    no scan waiting retire a pose."""
    from ssf_slam_tpu_torch.engine.streaming import StreamingRunner

    class InFlight:
        def query(self):
            return False

        def synchronize(self):
            pass

    orig = StreamingRunner._readback

    def readback(self, outs):
        return orig(self, outs)[0], InFlight()

    monkeypatch.setattr(StreamingRunner, "_readback", readback)


def _ended(sources, before):
    """Each source's thread joined within a bound, and no thread started
    since ``before`` still alive."""
    for src in sources:
        src.thread.join(timeout=10.0)
        assert not src.thread.is_alive()
    assert [t for t in threading.enumerate() if t not in before] == []


@pytest.mark.parametrize("depth,flavour", [(1, "ssf"), (2, "ssf"),
                                           (2, "ssfc"), (4, "ssf")])
def test_stream_matches_batch_under_one_box(model, frames, tmp_path, depth,
                                            flavour):
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
    assert stats["retired_early"] == (N_FRAMES if depth > 1 else 0)
    state = _batch_tum(model, frames, runner.box, tmp_path / "b.tum", seg)
    assert ((tmp_path / "s.tum").read_bytes()
            == (tmp_path / "b.tum").read_bytes())
    got = runner.final_state
    assert got.map_state.n_kf == state.map_state.n_kf
    torch.testing.assert_close(got.odom_t, state.odom_t, rtol=0, atol=0)
    torch.testing.assert_close(got.map_state.kf_t, state.map_state.kf_t,
                               rtol=0, atol=0)


def test_stream_retires_each_pose_before_the_next_pickup(
        model, frames, tmp_path, sources, copies_in_flight):
    """Depth 2, copies in flight, scans due every PERIOD (well above the
    small step's CPU time): no scan waits when a step returns, so the
    runner retires the pose then, and not after the next scan's dispatch.
    The source also waits, at most WAIT_S, for the poses of the scans
    before (the last one's too before it ends), so that a loaded host
    cannot queue a scan: nothing is left to the depth bound or the final
    drain."""
    from ssf_slam_tpu_torch.engine.streaming import StreamingRunner

    PERIOD, WAIT_S = 0.25, 10.0
    runner = StreamingRunner(model, _configs(N, "SSF", False, SMALL_STEP)[1],
                             tum_path=str(tmp_path / "s.tum"),
                             pipeline_depth=2, device="cpu")

    def posed(count):
        t_end = time.perf_counter() + WAIT_S
        while (len(runner.latencies_ms) < count
               and time.perf_counter() < t_end):
            time.sleep(0.002)

    def paced():
        t0 = time.perf_counter()
        for j, f in enumerate(frames):
            posed(j)
            time.sleep(max(t0 + j * PERIOD - time.perf_counter(), 0.0))
            yield f
        posed(len(frames))

    before = threading.enumerate()
    stats = runner.run(paced(), warmup=False)
    _ended(sources, before)
    assert len(sources) == 1
    recs = runner.timings
    assert [r.scan for r in recs] == list(range(N_FRAMES))
    for r, nxt in zip(recs, recs[1:]):
        assert r.retired < nxt.pickup
    assert stats["retired_early"] == N_FRAMES
    assert max(r.held for r in recs) < min(r.dispatched - r.pickup
                                           for r in recs)
    _batch_tum(model, frames, runner.box, tmp_path / "b.tum")
    assert ((tmp_path / "s.tum").read_bytes()
            == (tmp_path / "b.tum").read_bytes())


@pytest.mark.parametrize("depth", [2, 4])
def test_stream_holds_poses_in_flight_while_scans_wait(
        model, frames, tmp_path, sources, copies_in_flight, monkeypatch,
        depth):
    """Copies in flight, and a scan (or the end) always waiting when a step
    returns (the step waits for the source, at most WAIT_S): scan k is
    retired after scan k + depth - 1 was dispatched and before scan
    k + depth was taken, none early, in scan order."""
    import ssf_slam_tpu_torch.engine.streaming as streaming

    WAIT_S = 10.0
    orig = streaming.make_fused_step

    def make(*args, **kwargs):
        step, make_carry = orig(*args, **kwargs)

        def queued_step(carry, scan):
            out = step(carry, scan)
            t_end = time.perf_counter() + WAIT_S
            while (not sources[-1].waiting()
                   and time.perf_counter() < t_end):
                time.sleep(0.001)
            return out

        return queued_step, make_carry

    monkeypatch.setattr(streaming, "make_fused_step", make)
    runner, stats = _stream(model, frames, tmp_path / "s.tum", depth)
    assert stats["retired_early"] == 0
    recs = runner.timings
    assert [r.scan for r in recs] == list(range(N_FRAMES))
    for k in range(N_FRAMES - depth + 1):
        assert recs[k].retired > recs[k + depth - 1].dispatched
    for k in range(N_FRAMES - depth):
        assert recs[k].retired < recs[k + depth].pickup
    _batch_tum(model, frames, runner.box, tmp_path / "b.tum")
    assert ((tmp_path / "s.tum").read_bytes()
            == (tmp_path / "b.tum").read_bytes())


@pytest.mark.parametrize("fault", ["source", "step"])
def test_stream_stops_its_source_when_a_run_raises(model, frames, tmp_path,
                                                   sources, monkeypatch,
                                                   fault):
    """A source that fails after two scans, or a step that fails on the
    third scan of an endless source: ``run`` raises that error, and the
    source's thread has ended."""
    import ssf_slam_tpu_torch.engine.streaming as streaming

    def failing():
        yield from frames[:2]
        raise ValueError("sensor lost")

    feed = failing()
    if fault == "step":
        feed = (frames[j % N_FRAMES] for j in range(10 ** 6))
        orig = streaming.make_fused_step

        def make(*args, **kwargs):
            step, make_carry = orig(*args, **kwargs)
            calls = []

            def failing_step(carry, scan):
                calls.append(1)
                if len(calls) == 3:
                    raise ValueError("step failed")
                return step(carry, scan)

            return failing_step, make_carry

        monkeypatch.setattr(streaming, "make_fused_step", make)
    runner = streaming.StreamingRunner(
        model, _configs(N, "SSF", False, SMALL_STEP)[1],
        tum_path=str(tmp_path / "s.tum"), pipeline_depth=2, device="cpu")
    before = threading.enumerate()
    with pytest.raises(ValueError, match="sensor lost" if fault == "source"
                       else "step failed"):
        runner.run(feed, warmup=False)
    _ended(sources, before)
    assert len(sources) == 1


def test_frame_source_hands_over_every_frame_in_order():
    from ssf_slam_tpu_torch.engine.streaming import _FrameSource

    n_items, n_sources = 2000, (os.cpu_count() or 1) + 1
    got, errors = {}, []

    def consume(i):
        try:
            with _FrameSource(iter(range(n_items))) as src:
                seen = []
                while (item := src.get()) is not None:
                    src.waiting()
                    seen.append(item)
                    if item % 500 == 499:  # the source's put times out
                        time.sleep(2 * _FrameSource.POLL_S)
                    if i == 0 and len(seen) == 100:
                        break  # closed with frames still coming
                got[i] = (seen, src.thread)
        except Exception as exc:  # reported below, not lost in a thread
            errors.append(exc)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        workers = [threading.Thread(target=consume, args=(i,), daemon=True)
                   for i in range(n_sources)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=30.0)
            assert not w.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    assert got[0][0] == list(range(100))
    for i in range(1, n_sources):
        assert got[i][0] == list(range(n_items))
    for _, thread in got.values():
        thread.join(timeout=10.0)
        assert not thread.is_alive()


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
