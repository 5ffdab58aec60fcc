"""The port's whole SSF SLAM step against the JAX package, on the CPU.

- the out-and-back (``loop``) trajectory of the port's generator is
  byte-identical to the JAX package's;
- ``run_sequence_fused`` at the small TFlow (1024 points, banded kernels
  firing) over 16 frames, with a feature and refine configuration under
  which the scan-to-map refine accepts on most keyframes, against JAX
  ``engine/fused.py::run_sequence_fused``: pose_t / odom_t within 1e-4 m,
  quaternions within 1e-5, is_keyframe and n_features equal;
- the SSF ``run_sequence`` with a provided flow (ground truth x 1.03, an
  injected odometry drift) and the ground-truth static mask over the
  out-and-back circuit, loop gates scaled as in tests/test_engine.py: the
  loop closes in both, n_loops equal, pose_t within 1e-3 m;
- the port at full width (8192 points, f32, committed weights) over the
  first 2 bench frames against the committed JAX fixture
  ``tests/fixtures/torch_port/ssf_slam_ref.npz``: the poses at the
  tolerances above, is_keyframe / n_features / n_dyn_over equal, and the
  frame-(0, 1) finest flow of ``fuse_attention=True`` within a mean
  end-point difference of 1e-5 m.

Every test here rounds the port's kNN expansion as XLA's CPU compiler
rounds the JAX package's (``torch_ref.xla_cpu_sqdist``). The fixture is
made by

      JAX_PLATFORMS=cpu python tests/test_torch_slam.py --make-fixture
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ref  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _xla_cpu_knn(monkeypatch):
    torch_ref.round_knn_like_xla_cpu(monkeypatch)


SLAM_REF = os.path.join(torch_ref.FIXTURE_DIR, "ssf_slam_ref.npz")
N_FIXTURE_FRAMES = 8
T_TOL, Q_TOL = 1e-4, 1e-5
POSE_KEYS = (("pose_t", T_TOL), ("odom_t", T_TOL), ("rel_t", T_TOL),
             ("pose_q", Q_TOL), ("odom_q", Q_TOL), ("rel_q", Q_TOL))
EXACT_KEYS = ("is_keyframe", "n_features", "n_dyn_over")

# the small step: a looser curvature gate gives the 1024-point scans ~50
# features, the 2 m keyframe gate mixes keyframes with plain frames, and
# refine_stride 1 lets the refine reach its inlier gate
SMALL_STEP = dict(
    features=dict(max_features=512, plane_curv_max_16=1.0,
                  plane_stride_16=1),
    mapping=dict(max_keyframes=16, submap_points=1024, icp_iters=4,
                 loop_submap_halfwidth=2, refine_submap_points=512,
                 refine_stride=1, refine_min_inliers=16,
                 keyframe_trans_gate=2.0))


def _configs(n_points: int, step: dict, **flownet):
    """(JAX PipelineConfig, port PipelineConfig) of the SSF step."""
    from ssf_slam_tpu import config as jc
    from ssf_slam_tpu_torch import config as tc

    def build(mod):
        return mod.PipelineConfig(
            variant=mod.Variant.SSF,
            lidar=mod.LidarConfig(max_points=n_points),
            features=mod.FeatureConfig(**step.get("features", {})),
            mapping=mod.MappingConfig(**step.get("mapping", {})))

    return build(jc), build(tc)


def _assert_slam(got: dict, want: dict, n: int, t_tol: float = T_TOL,
                 q_tol: float = Q_TOL) -> None:
    for key, tol in POSE_KEYS:
        tol = t_tol if key.endswith("_t") else q_tol
        np.testing.assert_allclose(got[key], np.asarray(want[key])[:n],
                                   atol=tol, err_msg=key)
    for key in EXACT_KEYS:
        np.testing.assert_array_equal(got[key], np.asarray(want[key])[:n],
                                      err_msg=key)


def test_loop_trajectory_byte_identical():
    from ssf_slam_tpu.data.synthetic import generate_sequence as j_gen
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence as t_gen

    kw = dict(n_frames=30, n_points=1024, seed=21, noise=0.004, n_moving=2,
              trajectory="loop")
    jf, tf = j_gen(**kw), t_gen(**kw)
    assert len(jf) == len(tf) == 30
    for a, b in zip(jf, tf):
        assert a.keys() == b.keys()
        for key in a:
            if key in ("pose1", "pose2"):
                for x, y in zip(a[key], b[key]):
                    np.testing.assert_array_equal(x, y)
            elif key == "time":
                assert a[key] == b[key]
            else:
                assert a[key].tobytes() == b[key].tobytes(), key


def test_small_slam_step_matches_jax():
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ssf_slam_tpu.config import FlowNetConfig as JFlowNetConfig
    from ssf_slam_tpu.engine.fused import run_sequence_fused as j_run
    from ssf_slam_tpu.models import TFlow as JTFlow
    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence
    from ssf_slam_tpu_torch.engine.fused import run_sequence_fused
    from ssf_slam_tpu_torch.mapping import keyframes
    from ssf_slam_tpu_torch.ops import banded
    from ssf_slam_tpu_torch.weights import load_tflow

    frames = generate_sequence(n_frames=16, n_points=1024, seed=0,
                               noise=0.004, n_moving=4)
    jcfg, cfg = _configs(1024, SMALL_STEP)
    jmodel = JTFlow(cfg=JFlowNetConfig(**torch_ref.SMALL_NET))
    variables = jax.tree.map(jnp.asarray, torch_ref.load_npz_variables())
    with pltpu.force_tpu_interpret_mode():
        _, want = j_run(jmodel, variables, frames, jcfg)

    model = load_tflow(FlowNetConfig(**torch_ref.SMALL_NET), device="cpu")
    accepted = []
    refine = keyframes._refine_to_submap

    def spy(*args, **kw):
        out = refine(*args, **kw)
        accepted.append(bool(out[-1]))
        return out

    banded.reset_launches()
    keyframes._refine_to_submap = spy
    try:
        got = run_sequence_fused(model, frames, cfg, device="cpu")
    finally:
        keyframes._refine_to_submap = refine
    assert sum(banded.LAUNCHES.values()) == 0
    # the refine ran and accepted on several keyframes; both kinds of frame
    assert sum(accepted) >= 3, accepted
    assert 0 < got["is_keyframe"].sum() < len(frames)
    _assert_slam(got, want, len(frames))


def _loop_frames():
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    frames = generate_sequence(n_frames=72, n_points=1024, seed=21,
                               noise=0.004, n_moving=0, trajectory="loop")
    for f in frames:
        f["gt"] = f["gt"] * 1.03  # systematic odometry bias -> drift
        f["static_mask"] = f["s_fg_mask"] < 0.5
    return frames


def test_loop_closure_full_engine_matches_jax():
    from ssf_slam_tpu.engine.pipeline import run_sequence as j_run
    from ssf_slam_tpu_torch.engine.pipeline import run_sequence

    frames = _loop_frames()
    # gates scaled to the 72-frame circuit as in tests/test_engine.py; the
    # refine stays on (it is part of the step this holds)
    step = dict(mapping=dict(max_keyframes=96, loop_search_radius=8.0,
                             loop_time_gap=5.0, loop_skip_after_close=10,
                             submap_points=4096))
    jcfg, cfg = _configs(1024, step)
    jstate, want = j_run(frames, jcfg)
    state, got = run_sequence(frames, cfg, device="cpu")
    assert int(jstate.map_state.n_loops) > 0
    assert state.map_state.n_loops == int(jstate.map_state.n_loops)
    np.testing.assert_array_equal(got["is_keyframe"], want["is_keyframe"])
    np.testing.assert_allclose(got["pose_t"], want["pose_t"], atol=1e-3)
    np.testing.assert_allclose(got["odom_t"], want["odom_t"], atol=1e-3)


def bench_frames(n_frames: int = N_FIXTURE_FRAMES):
    from ssf_slam_tpu.data.synthetic import generate_sequence

    return generate_sequence(n_frames=32, n_points=8192, seed=0,
                             noise=0.004, n_moving=4)[:n_frames]


def make_fixture(path: str = SLAM_REF) -> None:
    """JAX reference of the whole step at full width: f32 TFlow, committed
    weights, banded backend (Pallas in interpret mode), the 8 first bench
    frames; plus frame (0, 1)'s finest flow with ``fuse_attention=True``."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ssf_slam_tpu.config import FlowNetConfig, PipelineConfig, Variant
    from ssf_slam_tpu.engine.evaluation import ate_rmse
    from ssf_slam_tpu.engine.fused import (
        run_sequence_fused,
        sequence_box,
        stack_fused_scans,
    )
    from ssf_slam_tpu.models import TFlow

    frames = bench_frames()
    variables = jax.tree.map(jnp.asarray, torch_ref.load_npz_variables())
    cfg = PipelineConfig(variant=Variant.SSF)
    net = dict(npoint=8192, joint_seg=True, dtype="float32",
               neighbor_backend="banded")
    with pltpu.force_tpu_interpret_mode():
        _, outs = run_sequence_fused(TFlow(cfg=FlowNetConfig(**net)),
                                     variables, frames, cfg)
        scans = stack_fused_scans(frames, 8192)
        box = sequence_box(np.asarray(scans["points"]))
        fused = TFlow(cfg=FlowNetConfig(**net, fuse_attention=True))
        tower = jax.jit(lambda pc: fused.apply(variables, pc, False, box,
                                               method=TFlow.tower))
        t0 = tower(scans["points"][0][None])
        t1 = tower(scans["points"][1][None])
        flows, _ = jax.jit(lambda a, b: fused.apply(
            variables, a, b, False, box, method=TFlow.head))(t0, t1)
    gt_pos = np.stack([f["pose1"][1] for f in frames])
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(
        path,
        **{k: np.asarray(outs[k]) for k in (
            "pose_q", "pose_t", "odom_q", "odom_t", "rel_q", "rel_t",
            "is_keyframe", "n_features", "n_dyn_over")},
        flow01_fused=np.asarray(flows[0][0]),
        box_origin=np.asarray(box[0]), box_scale=np.asarray(box[1]),
        gt_pos=gt_pos.astype(np.float32),
        ate_pose=np.float32(ate_rmse(outs["pose_t"], gt_pos)),
        ate_odom=np.float32(ate_rmse(outs["odom_t"], gt_pos)),
    )
    print(f"wrote {path}: {len(frames)} frames, keyframes "
          f"{np.asarray(outs['is_keyframe']).astype(int).tolist()}")


@pytest.fixture(scope="module")
def slam_ref():
    with np.load(SLAM_REF) as z:
        return {k: z[k] for k in z.files}


def _full_width(slam_ref, fuse_attention: bool):
    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence
    from ssf_slam_tpu_torch.engine.fused import sequence_box, stack_fused_scans
    from ssf_slam_tpu_torch.weights import load_tflow

    frames = generate_sequence(n_frames=32, n_points=8192, seed=0,
                               noise=0.004, n_moving=4)[:N_FIXTURE_FRAMES]
    box = sequence_box(stack_fused_scans(frames, 8192)["points"])
    np.testing.assert_array_equal(box[0].numpy(), slam_ref["box_origin"])
    np.testing.assert_array_equal(box[1].numpy(), slam_ref["box_scale"])
    model = load_tflow(FlowNetConfig(npoint=8192, joint_seg=True,
                                     neighbor_backend="banded",
                                     fuse_attention=fuse_attention),
                       device="cpu")
    return frames, box, model


def test_full_width_slam_first_frames_match_fixture(slam_ref):
    from ssf_slam_tpu_torch.engine.fused import run_sequence_fused

    frames, box, model = _full_width(slam_ref, False)
    got = run_sequence_fused(model, frames[:2], device="cpu", box=box)
    _assert_slam(got, slam_ref, 2)


def test_full_width_fused_attention_flow_matches_fixture(slam_ref):
    from ssf_slam_tpu_torch.engine.fused import stack_fused_scans
    from ssf_slam_tpu_torch.ops import attention

    frames, box, model = _full_width(slam_ref, True)
    pts = torch.as_tensor(stack_fused_scans(frames[:2], 8192)["points"])
    attention.reset_launches()
    with torch.inference_mode():
        flows, _ = model.head(model.tower(pts[0][None], box),
                              model.tower(pts[1][None], box), box)
    assert attention.LAUNCHES["cost_attention"] == 0  # the plain version
    flow, ref = flows[0][0].numpy(), slam_ref["flow01_fused"]
    epd = np.linalg.norm(flow[:, :3] - ref[:, :3], axis=-1).mean()
    assert epd < 1e-5, epd
    assert ((flow[:, 3] < 0) == (ref[:, 3] < 0)).mean() > 0.9999


if __name__ == "__main__":
    if sys.argv[1:] != ["--make-fixture"]:
        sys.exit("usage: python tests/test_torch_slam.py --make-fixture")
    import jax

    jax.config.update("jax_platforms", "cpu")
    make_fixture()
