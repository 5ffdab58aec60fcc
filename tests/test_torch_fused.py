"""The port's fused scene-flow odometry against the JAX package.

- ``run_sequence_fused`` at a small size (1024 points, banded levels firing)
  over 4 frames, against JAX ``engine/fused.py::run_sequence_fused``;
- the port at full width (8192 points, f32, committed weights) over the
  first 2 frames of the bench sequence, against the committed JAX fixture
  ``tests/fixtures/torch_port/ssf_fused_ref.npz``.

The small size's JAX side is committed too (``ssf_fused_small_ref.npz``:
live, it cost the suite a minute and a half, most of it compiling
interpret-mode Pallas). Both fixtures are made by

      JAX_PLATFORMS=cpu python tests/test_torch_fused.py --make-fixture

Tolerances (float32 on both sides, the same neighbour sets; what differs
is sum order in matmuls, softmaxes and the Kabsch sums):
- small size: rel_t / odom_t within 1e-4 m, quaternions within 1e-5;
- full width: rel_t / odom_t within 1e-4 m, quaternions within 1e-5, and
  a mean end-point difference of the frame-(0, 1) finest flow within
  1e-5 m with the static/moving verdict (seg logit < 0) equal on > 99.99 %
  of the points.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ref  # noqa: E402

torch.set_num_threads(1)

N_FIXTURE_FRAMES = 8
T_TOL, Q_TOL = 1e-4, 1e-5
SMALL_REF = os.path.join(torch_ref.FIXTURE_DIR, "ssf_fused_small_ref.npz")


def bench_frames(n_frames: int = N_FIXTURE_FRAMES):
    """The first frames of bench.py's sequence (seed 0, 8192 points)."""
    from ssf_slam_tpu.data.synthetic import generate_sequence

    return generate_sequence(n_frames=32, n_points=8192, seed=0,
                             noise=0.004, n_moving=4)[:n_frames]


def make_fixture(path: str = torch_ref.FUSED_REF) -> None:
    """JAX reference for the full-width slice: f32 TFlow, committed weights,
    banded backend (Pallas in interpret mode), the 8 first bench frames."""
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
    model = TFlow(cfg=FlowNetConfig(npoint=8192, joint_seg=True,
                                    dtype="float32",
                                    neighbor_backend="banded"))
    variables = jax.tree.map(jnp.asarray, torch_ref.load_npz_variables())
    cfg = PipelineConfig(variant=Variant.SSF)
    with pltpu.force_tpu_interpret_mode():
        _, outs = run_sequence_fused(model, variables, frames, cfg)
        scans = stack_fused_scans(frames, 8192)
        box = sequence_box(np.asarray(scans["points"]))
        tower = jax.jit(lambda pc: model.apply(variables, pc, False, box,
                                               method=TFlow.tower))
        t0 = tower(scans["points"][0][None])
        t1 = tower(scans["points"][1][None])
        flows, _ = jax.jit(lambda a, b: model.apply(
            variables, a, b, False, box, method=TFlow.head))(t0, t1)
    gt_pos = np.stack([f["pose1"][1] for f in frames])
    ate = ate_rmse(outs["odom_t"], gt_pos)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(
        path,
        rel_q=outs["rel_q"], rel_t=outs["rel_t"],
        odom_q=outs["odom_q"], odom_t=outs["odom_t"],
        flow01=np.asarray(flows[0][0]),
        box_origin=np.asarray(box[0]), box_scale=np.asarray(box[1]),
        gt_pos=gt_pos.astype(np.float32), ate=np.float32(ate),
    )
    print(f"wrote {path}: {len(frames)} frames, JAX ATE {ate:.6f} m")


def _assert_odometry(got: dict, want: dict, n: int) -> None:
    for key, tol in (("rel_t", T_TOL), ("odom_t", T_TOL), ("rel_q", Q_TOL),
                     ("odom_q", Q_TOL)):
        np.testing.assert_allclose(got[key], np.asarray(want[key])[:n],
                                   atol=tol, err_msg=key)


@pytest.fixture(scope="module")
def small_frames():
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    return generate_sequence(n_frames=4, n_points=1024, seed=0, noise=0.004,
                             n_moving=4)


def make_small_fixture(path: str = SMALL_REF) -> None:
    """JAX ``run_sequence_fused`` of the small TFlow (Pallas in interpret
    mode) over the 4 small frames."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ssf_slam_tpu.config import FeatureConfig, MappingConfig
    from ssf_slam_tpu.config import FlowNetConfig as JFlowNetConfig
    from ssf_slam_tpu.config import PipelineConfig as JPipelineConfig
    from ssf_slam_tpu.config import Variant as JVariant
    from ssf_slam_tpu.data.synthetic import generate_sequence
    from ssf_slam_tpu.engine.fused import run_sequence_fused as j_run
    from ssf_slam_tpu.models import TFlow as JTFlow

    frames = generate_sequence(n_frames=4, n_points=1024, seed=0,
                               noise=0.004, n_moving=4)
    # the JAX step also runs the mapping back end (which does not feed
    # these outputs): keep it small
    jcfg = JPipelineConfig(
        variant=JVariant.SSF, features=FeatureConfig(max_features=512),
        mapping=MappingConfig(max_keyframes=16, submap_points=1024,
                              icp_iters=4, loop_submap_halfwidth=2,
                              refine_submap_points=512))
    jcfg = jcfg.replace(lidar=dataclasses.replace(jcfg.lidar,
                                                  max_points=1024))
    jmodel = JTFlow(cfg=JFlowNetConfig(**torch_ref.SMALL_NET))
    variables = jax.tree.map(jnp.asarray, torch_ref.load_npz_variables())
    with pltpu.force_tpu_interpret_mode():
        _, want = j_run(jmodel, variables, frames, jcfg)
    np.savez(path, **{k: np.asarray(want[k])
                      for k in ("rel_q", "rel_t", "odom_q", "odom_t")})
    print(f"wrote {path}")


def test_small_run_sequence_fused_matches_jax(small_frames):
    from ssf_slam_tpu_torch.config import FlowNetConfig, LidarConfig
    from ssf_slam_tpu_torch.config import PipelineConfig, Variant
    from ssf_slam_tpu_torch.engine.fused import run_sequence_fused
    from ssf_slam_tpu_torch.ops import banded
    from ssf_slam_tpu_torch.weights import load_tflow

    with np.load(SMALL_REF) as z:
        want = {k: z[k] for k in z.files}
    model = load_tflow(FlowNetConfig(**torch_ref.SMALL_NET), device="cpu")
    cfg = PipelineConfig(variant=Variant.SSF,
                         lidar=LidarConfig(max_points=1024))
    banded.reset_launches()
    got = run_sequence_fused(model, small_frames, cfg, device="cpu")
    assert sum(banded.LAUNCHES.values()) == 0
    assert got["flow"].shape == (4, 1024, 4)
    np.testing.assert_array_equal(got["rel_q"][0], [0, 0, 0, 1])
    np.testing.assert_array_equal(got["rel_t"][0], [0, 0, 0])
    _assert_odometry(got, want, 4)


@pytest.fixture(scope="module")
def fixture_ref():
    with np.load(torch_ref.FUSED_REF) as z:
        return {k: z[k] for k in z.files}


def test_full_width_first_frames_match_fixture(fixture_ref):
    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence
    from ssf_slam_tpu_torch.engine.fused import (
        run_sequence_fused,
        sequence_box,
        stack_fused_scans,
    )
    from ssf_slam_tpu_torch.weights import load_tflow

    frames = generate_sequence(n_frames=32, n_points=8192, seed=0,
                               noise=0.004, n_moving=4)[:N_FIXTURE_FRAMES]
    # the fixture ran under the box of its 8 frames; run 2 of them under it
    box = sequence_box(stack_fused_scans(frames, 8192)["points"])
    np.testing.assert_array_equal(box[0].numpy(), fixture_ref["box_origin"])
    np.testing.assert_array_equal(box[1].numpy(), fixture_ref["box_scale"])
    model = load_tflow(FlowNetConfig(npoint=8192, joint_seg=True,
                                     neighbor_backend="banded"),
                       device="cpu")
    got = run_sequence_fused(model, frames[:2], device="cpu", box=box)
    _assert_odometry(got, fixture_ref, 2)
    flow, ref = got["flow"][1], fixture_ref["flow01"]
    epd = np.linalg.norm(flow[:, :3] - ref[:, :3], axis=-1).mean()
    assert epd < 1e-5, epd
    assert ((flow[:, 3] < 0) == (ref[:, 3] < 0)).mean() > 0.9999


if __name__ == "__main__":
    if sys.argv[1:] not in (["--make-fixture"], ["--make-fixture", "small"]):
        sys.exit("usage: python tests/test_torch_fused.py --make-fixture "
                 "[small]")
    import jax

    jax.config.update("jax_platforms", "cpu")
    make_small_fixture()
    if sys.argv[2:] != ["small"]:
        make_fixture()
