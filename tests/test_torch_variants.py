"""The port's other pipeline variants (ONLY_PC, SEG, NO_SEG, SF) and
``geom_refine`` against the JAX package, on the CPU.

Unit parity (the same numpy inputs, made from a seed, through each JAX
function and its port; float32 on both sides):
- ``quat_from_rpy`` 1e-6;
- ``gmm_em`` on [flow || xyz] of a 1024-point generated pair: labels equal,
  means 1e-4, weights 1e-5; ``gmm_background_mask`` equal;
- ``ego_motion_gt_seg`` / ``ego_motion_gmm``: q 1e-5, t 1e-4 m, the GMM's
  background equal;
- ``rpe``, ``rpe_rmse``, the TUM round trip and ``utils/poses.py`` against
  the JAX package's copies (equal); every dataclass default of the
  ``PipelineConfig`` tree equal to the JAX package's.
The BEV init, the plane fit, the scan-to-scan GN and the refine are held in
tests/test_torch_bev.py.

Whole sequences against committed JAX fixtures (live, the JAX side would
cost minutes of the suite, most of it interpret-mode Pallas):
- ``variants_small_ref.npz`` (here): 16 frames x 1024 points, the small
  step of tests/test_torch_slam.py; ONLY_PC, SEG, NO_SEG, SF with
  ``geom_refine`` and SSF with ``geom_refine`` through ``run_sequence`` on
  a provided flow (ground truth x 1.03, so that the refine has a bias to
  correct), and SF through ``run_sequence_fused(use_gmm=True)`` with the
  small TFlow: poses within 1e-4 m / 1e-5, is_keyframe / n_features /
  n_dyn_over equal;
- ``variants_ref.npz`` (tests/test_torch_variants_full.py): the full-width
  f32 runs (8192 points, committed weights, the first 8 bench frames) that
  the chip check holds on the card: SF fused, SF fused with
  ``geom_refine``, SSF fused with ``geom_refine``, and SEG, NO_SEG and
  ONLY_PC on the ground-truth flow.

The mapping back end thresholds the kNN expansion distances as they are,
so every test here rounds them as XLA's CPU compiler does
(``torch_ref.round_knn_like_xla_cpu``). Both fixtures are made by

      JAX_PLATFORMS=cpu python tests/test_torch_variants.py --make-fixture

(``--make-fixture small`` or ``full`` makes one of them).
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


SMALL_REF = os.path.join(torch_ref.FIXTURE_DIR, "variants_small_ref.npz")
FULL_REF = os.path.join(torch_ref.FIXTURE_DIR, "variants_ref.npz")
T_TOL, Q_TOL = 1e-4, 1e-5
POSE_KEYS = ("pose_t", "odom_t", "rel_t", "pose_q", "odom_q", "rel_q")
EXACT_KEYS = ("is_keyframe", "n_features", "n_dyn_over")
N_FIXTURE_FRAMES = 8

# the small step of tests/test_torch_slam.py (~50 features a scan)
SMALL_STEP = dict(
    features=dict(max_features=512, plane_curv_max_16=1.0,
                  plane_stride_16=1),
    mapping=dict(max_keyframes=16, submap_points=1024, icp_iters=4,
                 loop_submap_halfwidth=2, refine_submap_points=512,
                 refine_stride=1, refine_min_inliers=16,
                 keyframe_trans_gate=2.0))
# name -> (variant, geom_refine, fused): the whole-sequence runs. The
# small ONLY_PC run leaves the BEV init out: with ~30 features a scan its
# correlation scores are counts of 8-13 that tie exactly between cells and
# yaws, and the two FFTs' roundings break the ties differently (ROADMAP
# §3); the BEV init is held by the unit tests and the full-width run
SMALL_RUNS = {"onlypc": ("ONLY_PC", False, False),
              "seg": ("SEG", False, False),
              "noseg": ("NO_SEG", False, False),
              "sf_refine": ("SF", True, False),
              "ssf_refine": ("SSF", True, False),
              "sf_fused": ("SF", False, True)}
FULL_RUNS = {"sf": ("SF", False, True),
             "sf_refine": ("SF", True, True),
             "ssf_refine": ("SSF", True, True),
             "seg": ("SEG", False, False),
             "noseg": ("NO_SEG", False, False),
             "onlypc": ("ONLY_PC", False, False)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    import jax

    return jax.tree.map(np.asarray, tree)


def _configs(n_points: int, variant: str, geom_refine: bool, step: dict):
    """(JAX PipelineConfig, port PipelineConfig) of one run; ``step``
    overrides the features, mapping and odometry defaults."""
    from ssf_slam_tpu import config as jc
    from ssf_slam_tpu_torch import config as tc

    def build(mod):
        return mod.PipelineConfig(
            variant=mod.Variant[variant],
            lidar=mod.LidarConfig(max_points=n_points),
            features=mod.FeatureConfig(**step.get("features", {})),
            odometry=mod.OdometryConfig(**step.get("odometry", {})),
            egomotion=mod.EgoMotionConfig(geom_refine=geom_refine),
            mapping=mod.MappingConfig(**step.get("mapping", {})))

    return build(jc), build(tc)


def _with_flow(frames):
    """A provided flow with a bias (ground truth x 1.03) and the ground-
    truth static mask."""
    for f in frames:
        f["flow"] = (f["gt"] * 1.03).astype(np.float32)
        f["static_mask"] = f["s_fg_mask"] < 0.5
    return frames


def _small_frames():
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    return _with_flow(generate_sequence(n_frames=16, n_points=1024, seed=0,
                                        noise=0.004, n_moving=4))


def bench_frames(n_frames: int = N_FIXTURE_FRAMES):
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    return generate_sequence(n_frames=32, n_points=8192, seed=0,
                             noise=0.004, n_moving=4)[:n_frames]


def _assert_run(got: dict, want: dict, n: int, name: str) -> None:
    for key in POSE_KEYS:
        tol = T_TOL if key.endswith("_t") else Q_TOL
        np.testing.assert_allclose(got[key], want[key][:n], atol=tol,
                                   err_msg=f"{name} {key}")
    for key in EXACT_KEYS:
        np.testing.assert_array_equal(got[key], want[key][:n],
                                      err_msg=f"{name} {key}")


# ------------------------------------------------------------------- units


def _pair(n_points: int = 1024, seed: int = 100, k: int = 2):
    """Frame k of a generated sequence: (pts, gt flow, fg mask, valid)."""
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    f = generate_sequence(n_frames=k + 1, n_points=n_points, seed=seed,
                          noise=0.004, n_moving=4)[k]
    return (f["pos1"].astype(np.float32), f["gt"].astype(np.float32),
            f["s_fg_mask"].astype(np.float32), f["mask1"].astype(bool))


def test_quat_from_rpy_matches_jax():
    import jax.numpy as jnp

    from ssf_slam_tpu.ops.se3 import quat_from_rpy as jf
    from ssf_slam_tpu_torch.ops.se3 import quat_from_rpy as tf

    rpy = np.random.default_rng(0).uniform(-3, 3, (3, 64)).astype(np.float32)
    want = np.asarray(jf(*map(jnp.asarray, rpy)))
    np.testing.assert_allclose(tf(*map(_t, rpy)).numpy(), want, atol=1e-6)


def test_gmm_em_matches_jax():
    import jax.numpy as jnp

    from ssf_slam_tpu.ops.gmm import gmm_background_mask as jbg
    from ssf_slam_tpu.ops.gmm import gmm_em as jem
    from ssf_slam_tpu_torch.ops.gmm import gmm_background_mask as tbg
    from ssf_slam_tpu_torch.ops.gmm import gmm_em as tem

    pts, flow, _, valid = _pair()
    x = np.concatenate([flow, pts], axis=-1)
    jl, _, jm, jw = _np(jem(jnp.asarray(x), jnp.asarray(valid)))
    tl, _, tm, tw = (a.numpy() for a in tem(_t(x), _t(valid)))
    # both clusters populated: the split is a real one
    assert 0 < (tl[valid] == 1).sum() < valid.sum()
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(tm, jm, atol=1e-4)
    np.testing.assert_allclose(tw, jw, atol=1e-5)
    np.testing.assert_array_equal(
        tbg(_t(x), _t(valid)).numpy(),
        np.asarray(jbg(jnp.asarray(x), jnp.asarray(valid))))


@pytest.mark.parametrize("fn", ["ego_motion_gt_seg", "ego_motion_gmm"])
def test_ego_motion_variants_match_jax(fn):
    import jax.numpy as jnp

    from ssf_slam_tpu.odometry import egomotion as je
    from ssf_slam_tpu_torch.odometry import egomotion as te

    pts, flow, fg, valid = _pair()
    flow = flow * 1.03  # a biased flow: the IRLS has work to do
    third = fg if fn == "ego_motion_gt_seg" else None
    jargs = [jnp.asarray(a) for a in (pts, flow, third, valid)
             if a is not None]
    targs = [_t(a) for a in (pts, flow, third, valid) if a is not None]
    want = _np(getattr(je, fn)(*jargs))
    got = [a.numpy() for a in getattr(te, fn)(*targs)]
    np.testing.assert_allclose(got[0], want[0], atol=Q_TOL)
    np.testing.assert_allclose(got[1], want[1], atol=T_TOL)
    if fn == "ego_motion_gmm":
        np.testing.assert_array_equal(got[2], want[2])


def _trajectory(rng, n=40):
    from scipy.spatial.transform import Rotation

    pos = np.cumsum(rng.normal(0, 0.5, (n, 3)), axis=0)
    quat = Rotation.from_rotvec(np.cumsum(rng.normal(0, 0.02, (n, 3)),
                                          axis=0)).as_quat()
    return pos, quat


def test_rpe_matches_jax():
    from scipy.spatial.transform import Rotation

    from ssf_slam_tpu.engine import evaluation as je
    from ssf_slam_tpu_torch.engine import evaluation as te

    rng = np.random.default_rng(5)
    ref_pos, ref_q = _trajectory(rng)
    est_pos = ref_pos + rng.normal(0, 0.05, ref_pos.shape)
    est_q = (Rotation.from_quat(ref_q)
             * Rotation.from_rotvec(rng.normal(0, 0.01, (40, 3)))).as_quat()
    for delta in (1, 3):
        # quaternions and matrices
        for er, rr in ((est_q, ref_q), (Rotation.from_quat(est_q).as_matrix(),
                                        Rotation.from_quat(ref_q).as_matrix())):
            assert (te.rpe(est_pos, er, ref_pos, rr, delta=delta)
                    == je.rpe(est_pos, er, ref_pos, rr, delta=delta))
        assert (te.rpe_rmse(est_pos, ref_pos, est_q, ref_q, delta=delta)
                == je.rpe_rmse(est_pos, ref_pos, est_q, ref_q, delta=delta))


def test_tum_and_pose_files_match_jax(tmp_path):
    from ssf_slam_tpu.engine import evaluation as je
    from ssf_slam_tpu.utils import poses as jp
    from ssf_slam_tpu_torch.engine import evaluation as te
    from ssf_slam_tpu_torch.utils import poses as tp

    pos, quat = _trajectory(np.random.default_rng(6), 12)
    times = np.arange(12) * 0.1
    te.write_tum(str(tmp_path / "t.tum"), times, pos, quat)
    je.write_tum(str(tmp_path / "j.tum"), times, pos, quat)
    assert (tmp_path / "t.tum").read_bytes() == (tmp_path / "j.tum").read_bytes()
    for a, b in zip(te.read_tum(str(tmp_path / "t.tum")),
                    je.read_tum(str(tmp_path / "t.tum"))):
        np.testing.assert_array_equal(a, b)
    tp.tum_file_to_kitti(str(tmp_path / "t.tum"), str(tmp_path / "t.kitti"))
    jp.tum_file_to_kitti(str(tmp_path / "t.tum"), str(tmp_path / "j.kitti"))
    kt = (tmp_path / "t.kitti").read_bytes()
    assert kt == (tmp_path / "j.kitti").read_bytes()
    mats = tp.read_kitti_poses(str(tmp_path / "t.kitti"))
    np.testing.assert_array_equal(mats, jp.read_kitti_poses(
        str(tmp_path / "t.kitti")))
    np.testing.assert_array_equal(tp.relative_pose(mats[0], mats[5]),
                                  jp.relative_pose(mats[0], mats[5]))
    assert tp.mat_to_kitti(mats[3]) == jp.mat_to_kitti(mats[3])
    np.testing.assert_array_equal(tp.kitti_to_mat(tp.mat_to_kitti(mats[3])),
                                  jp.kitti_to_mat(jp.mat_to_kitti(mats[3])))
    np.testing.assert_array_equal(te._as_rotmats(quat), je._as_rotmats(quat))


def _defaults(obj) -> dict:
    """Every field default of a dataclass tree, by dotted name; enums by
    value."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": x for k, x in _defaults(v).items()})
        else:
            out[f.name] = getattr(v, "value", v)
    return out


def test_pipeline_config_defaults_match_jax():
    from ssf_slam_tpu import config as jc
    from ssf_slam_tpu_torch import config as tc

    assert tc.PipelineConfig().variant is tc.Variant.ONLY_PC
    assert _defaults(tc.PipelineConfig()) == _defaults(jc.PipelineConfig())
    assert {v.name: v.value for v in tc.Variant} == {
        v.name: v.value for v in jc.Variant}


# --------------------------------------------------------------- fixtures


def _jax_run(name, spec, frames, n_points, step, net=None):
    """One run of the JAX package (Pallas in interpret mode)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ssf_slam_tpu.config import FlowNetConfig
    from ssf_slam_tpu.engine.fused import run_sequence_fused
    from ssf_slam_tpu.engine.pipeline import run_sequence
    from ssf_slam_tpu.models import TFlow

    variant, refine, fused = spec
    jcfg, _ = _configs(n_points, variant, refine, step)
    if not fused:
        _, outs = run_sequence(frames, jcfg, flow_key="flow")
    else:
        variables = jax.tree.map(jnp.asarray,
                                 torch_ref.load_npz_variables())
        with pltpu.force_tpu_interpret_mode():
            _, outs = run_sequence_fused(
                TFlow(cfg=FlowNetConfig(**net)), variables, frames, jcfg,
                use_gmm=variant == "SF")
    print(f"  {name}: keyframes "
          f"{np.asarray(outs['is_keyframe']).astype(int).tolist()}")
    return {f"{name}/{k}": np.asarray(outs[k]) for k in (*POSE_KEYS,
                                                          *EXACT_KEYS)}


def _small_step(variant: str) -> dict:
    if variant != "ONLY_PC":
        return SMALL_STEP
    return dict(SMALL_STEP, odometry=dict(bev_init=False))


def make_small_fixture(path: str = SMALL_REF) -> None:
    frames = _small_frames()
    out = {}
    for name, spec in SMALL_RUNS.items():
        out.update(_jax_run(name, spec, frames, 1024, _small_step(spec[0]),
                            net=torch_ref.SMALL_NET))
    np.savez(path, **out)
    print(f"wrote {path}")


def make_full_fixture(path: str = FULL_REF) -> None:
    """The full-width runs: f32 TFlow at 8192 points with the committed
    weights, the first 8 bench frames, the default step."""
    frames = _with_exact_gt(bench_frames())
    net = dict(npoint=8192, joint_seg=True, dtype="float32",
               neighbor_backend="banded")
    out = {}
    for name, spec in FULL_RUNS.items():
        out.update(_jax_run(name, spec, frames, 8192, {}, net=net))
    np.savez(path, **out)
    print(f"wrote {path}")


def _with_exact_gt(frames):
    """The full-width runs' provided flow: the ground truth itself."""
    for f in frames:
        f["flow"] = f["gt"].astype(np.float32)
    return frames


@pytest.fixture(scope="module")
def small_ref():
    with np.load(SMALL_REF) as z:
        return {k: z[k] for k in z.files}


def _port_run(spec, frames, n_points, step, net=None, box=None):
    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.engine.fused import run_sequence_fused
    from ssf_slam_tpu_torch.engine.pipeline import run_sequence
    from ssf_slam_tpu_torch.ops import banded
    from ssf_slam_tpu_torch.weights import load_tflow

    variant, refine, fused = spec
    _, cfg = _configs(n_points, variant, refine, step)
    if not fused:
        return run_sequence(frames, cfg, flow_key="flow", device="cpu")[1]
    model = load_tflow(FlowNetConfig(**net), device="cpu")
    banded.reset_launches()
    got = run_sequence_fused(model, frames, cfg, device="cpu", box=box,
                             use_gmm=variant == "SF")
    assert sum(banded.LAUNCHES.values()) == 0  # the plain versions
    return got


@pytest.mark.parametrize("name", list(SMALL_RUNS))
def test_small_variant_matches_jax(small_ref, name):
    spec = SMALL_RUNS[name]
    got = _port_run(spec, _small_frames(), 1024, _small_step(spec[0]),
                    net=torch_ref.SMALL_NET)
    want = {k.split("/", 1)[1]: v for k, v in small_ref.items()
            if k.startswith(name + "/")}
    assert 0 < got["is_keyframe"].sum()
    _assert_run(got, want, len(got["pose_t"]), name)


if __name__ == "__main__":
    if sys.argv[1:] not in (["--make-fixture"], ["--make-fixture", "small"],
                            ["--make-fixture", "full"]):
        sys.exit("usage: python tests/test_torch_variants.py --make-fixture "
                 "[small|full]")
    import jax

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[2:] != ["full"]:
        make_small_fixture()
    if sys.argv[2:] != ["small"]:
        make_full_fixture()
