"""SLAM state checkpoints (engine/checkpoint.py) on the CPU: the SEG
variant (no network) over a small sequence (6 frames x 1024 points, the
small SLAM step of tests/test_torch_variants.py).

- a round trip leaves every leaf of the state as it was;
- 3 scans, save, load, 3 more scans give the uninterrupted run's poses;
- the JAX package's state after 3 scans, converted by
  ``slam_state_from_flax``, continues through 3 more scans as the JAX
  package's does (poses within 1e-5 m, keyframes equal);
- a payload without ``kf_rnorm`` / ``kf_rvalid`` / ``n_loops_total``
  loads with the JAX package's backfill.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ref  # noqa: E402
from test_torch_variants import SMALL_STEP, _configs  # noqa: E402

torch.set_num_threads(1)

N, N_FRAMES, SPLIT = 1024, 6, 3
TOL = 1e-5


@pytest.fixture(autouse=True)
def _xla_cpu_knn(monkeypatch):
    torch_ref.round_knn_like_xla_cpu(monkeypatch)


@pytest.fixture(scope="module")
def frames():
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    return generate_sequence(n_frames=N_FRAMES, n_points=N, seed=1,
                             noise=0.004, n_moving=4)


def _run(frames, cfg, state=None, start=0, stop=N_FRAMES):
    """The port's SLAM step over scans [start, stop) of the stacked
    frames, from ``state`` (a fresh one by default)."""
    from ssf_slam_tpu_torch.engine.pipeline import (
        init_slam_state,
        slam_step,
        stack_outputs,
        stack_scans,
    )

    scans = {k: torch.as_tensor(v)
             for k, v in stack_scans(frames, cfg).items()}
    state = init_slam_state(cfg, "cpu") if state is None else state
    outs = []
    with torch.inference_mode():
        for k in range(start, stop):
            state, o = slam_step(state, {key: v[k] for key, v in
                                         scans.items()}, cfg)
            outs.append(o)
    return state, stack_outputs(outs)


def _leaves(state) -> dict:
    from ssf_slam_tpu_torch.engine.checkpoint import _flatten

    return _flatten(state)


def test_round_trip(frames, tmp_path):
    from ssf_slam_tpu_torch.engine.checkpoint import (
        load_slam_state,
        save_slam_state,
    )

    cfg = _configs(N, "SEG", False, SMALL_STEP)[1]
    state, _ = _run(frames, cfg, stop=SPLIT)
    assert state.map_state.n_kf > 0
    save_slam_state(str(tmp_path / "s.npz"), state, SPLIT)
    back, index = load_slam_state(str(tmp_path / "s.npz"), cfg, "cpu")
    assert index == SPLIT
    want, got = _leaves(state), _leaves(back)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert isinstance(back.map_state.n_kf, int) and back.have_last is True


def test_resume_matches_uninterrupted(frames, tmp_path):
    from ssf_slam_tpu_torch.engine.checkpoint import (
        load_slam_state,
        save_slam_state,
    )

    cfg = _configs(N, "SEG", False, SMALL_STEP)[1]
    _, whole = _run(frames, cfg)
    state, first = _run(frames, cfg, stop=SPLIT)
    save_slam_state(str(tmp_path / "s.npz"), state, SPLIT)
    back, index = load_slam_state(str(tmp_path / "s.npz"), cfg, "cpu")
    _, rest = _run(frames, cfg, back, start=index)
    for key in ("pose_t", "pose_q", "odom_t", "is_keyframe"):
        np.testing.assert_array_equal(
            np.concatenate([first[key], rest[key]]), whole[key], err_msg=key)


def test_jax_state_continues_in_the_port(frames):
    import jax

    from ssf_slam_tpu.engine.pipeline import (
        run_sequence,
        run_sequence_scan,
        stack_scans,
    )
    from ssf_slam_tpu_torch.engine.checkpoint import slam_state_from_flax

    jcfg, cfg = _configs(N, "SEG", False, SMALL_STEP)
    jstate, jfirst = run_sequence(frames[:SPLIT], jcfg)
    scans = stack_scans(frames, jcfg)
    _, jrest = run_sequence_scan(
        jstate, {k: v[SPLIT:] for k, v in scans.items()}, jcfg)
    state = slam_state_from_flax(jax.tree.map(np.asarray, jstate), cfg,
                                 "cpu")
    assert state.map_state.n_kf == int(jstate.map_state.n_kf) > 0
    np.testing.assert_array_equal(
        state.map_state.kf_cloud.numpy(),
        np.swapaxes(np.asarray(jstate.map_state.kf_cloud), 1, 2))
    _, rest = _run(frames, cfg, state, start=SPLIT)
    for key in ("pose_t", "odom_t"):
        np.testing.assert_allclose(rest[key], np.asarray(jrest[key]),
                                   atol=TOL, err_msg=key)
    np.testing.assert_allclose(rest["pose_q"], np.asarray(jrest["pose_q"]),
                               atol=TOL)
    np.testing.assert_array_equal(rest["is_keyframe"],
                                  np.asarray(jrest["is_keyframe"]))


def test_legacy_payload_backfill(frames, tmp_path):
    from ssf_slam_tpu_torch.engine.checkpoint import (
        load_slam_state,
        save_slam_state,
    )

    cfg = _configs(N, "SEG", False, SMALL_STEP)[1]
    state, _ = _run(frames, cfg, stop=SPLIT)
    save_slam_state(str(tmp_path / "s.npz"), state, SPLIT)
    with np.load(tmp_path / "s.npz") as z:
        payload = {k: z[k] for k in z.files}
    for drop in (("kf_rnorm", "kf_rvalid"),
                 ("kf_rnorm", "kf_rvalid", "n_loops_total")):
        legacy = {k: v for k, v in payload.items()
                  if k.split("/")[-1] not in drop}
        np.savez(tmp_path / "old.npz", **legacy)
        back, index = load_slam_state(str(tmp_path / "old.npz"), cfg, "cpu")
        ms = back.map_state
        assert index == SPLIT
        assert not ms.kf_rvalid.any() and not ms.kf_rnorm.any()
        assert ms.n_loops_total == ms.n_loops == state.map_state.n_loops
        np.testing.assert_array_equal(ms.kf_cloud.numpy(),
                                      state.map_state.kf_cloud.numpy())
