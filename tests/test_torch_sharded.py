"""Scale-out across processes (``ssf_slam_tpu_torch/parallel/mesh.py``:
``make_mesh``, ``shard_batch``, ``make_sharded_train_step``,
``run_sequences_sharded``, ``run_sequences_sharded_streaming``) against the
JAX package, on the CPU.

The port's ranks are processes over gloo (``mesh.spawn``, one torch thread
each, joined under a timeout so that a hang fails one test); JAX's mesh is
the 8 virtual CPU devices tests/conftest.py makes.

- ``run_sequences_sharded`` without a model at D = 2, live against JAX's
  on ``make_mesh(2)`` in tests/test_torch_parallel.py's SEG configuration:
  poses within 1e-4 m, keyframe flags equal off the 1.0 m gate's knife
  edge (ROADMAP §3);
- with the small f32 TFlow at D = 2 against a committed JAX run
  (``sharded_small_ref.npz``, Pallas in interpret mode): poses within
  1e-4 m / 1e-5; each member equals ``run_sequence_fused`` alone under the
  shared box within 1e-5 m;
- streaming from an ``SsfbStripe`` equals the batch run (JAX's own
  property, tests/test_parallel.py::
  test_sequences_sharded_streaming_matches_batch, at its 1e-3 on the
  exact path; on the banded path under the stream's box within 1e-5 m),
  and a stripe of a rank's own stream gives what the whole stripe gives;
- ``make_sharded_train_step`` at D = 2, f32, a batch of 4: against the one
  process ``make_train_step`` on the whole batch (loss within 1e-6
  relative, batch statistics within 1e-6, parameters after the optax
  chain's step within 1e-6 wherever Adam's update of the two runs'
  gradients agrees within 1e-7, off Adam's edge of ROADMAP §3; the
  averaged gradients leaf by leaf within 1e-5 of the leaf's norm plus a
  floor of 1e-6 of the largest),
  and against JAX's
  ``make_sharded_train_step`` on two devices (committed: the loss, the new
  batch statistics and each gradient leaf's norm and CountSketch, at
  tests/test_torch_train.py's tolerances and its knife-edge allowance; on
  the exact neighbour path, since GSPMD cannot partition interpret-mode
  Pallas).

The fixture is made by

    JAX_PLATFORMS=cpu python tests/test_torch_sharded.py --make-fixture
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ref  # noqa: E402
import torch_sharded_workers as workers  # noqa: E402
from test_torch_parallel import (  # noqa: E402
    FUSED_STEP,
    N_FUSED,
    N_FUSED_FRAMES,
    _assert_keyframes_equal_off_the_gate,
    _fused_seqs,
    _pad,
)
from test_torch_variants import POSE_KEYS, Q_TOL, T_TOL, _configs  # noqa: E402

torch.set_num_threads(1)

SHARDED_REF = os.path.join(torch_ref.FIXTURE_DIR, "sharded_small_ref.npz")
D = 2
ALONE_TOL = 1e-5
SPAWN_TIMEOUT = 120.0
# JAX's sharded train step runs on the exact neighbour path: GSPMD cannot
# partition interpret-mode Pallas (its io_callbacks are side effects)
XLA_NET = dict(neighbor_backend="xla")
TRAIN_KEYS = ("pos1", "pos2", "gt", "ego_flow", "s_fg_mask", "t_fg_mask",
              "mask1", "mask2")


def _train_batch():
    """Four frame pairs of 1024 points (all of JAX's batch keys) and their
    label weights."""
    from ssf_slam_tpu_torch.data.carla import compute_label_weights
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    frames = generate_sequence(n_frames=4, n_points=1024, seed=7,
                               noise=0.004, n_moving=4)
    lw = compute_label_weights(frames)
    batch = {k: np.stack([f[k] for f in frames]).astype(np.float32)
             for k in TRAIN_KEYS}
    return batch, (float(lw[0]), float(lw[1]))


def make_fixture(path: str = SHARDED_REF) -> None:
    """JAX's fused ``run_sequences_sharded`` of tests/test_torch_parallel's
    two small sequences on a mesh of 2, and one f32
    ``make_sharded_train_step`` of the small TFlow on ``_train_batch``
    with an optimizer that keeps the gradient in its state."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.experimental.pallas import tpu as pltpu

    from ssf_slam_tpu.config import FlowNetConfig, LossConfig, TrainConfig
    from ssf_slam_tpu.models import TFlow
    from ssf_slam_tpu.parallel.mesh import (
        make_mesh,
        make_sharded_train_step,
        run_sequences_sharded,
        shard_batch,
    )
    from ssf_slam_tpu.train.trainer import TrainState

    mesh = make_mesh(D)
    model = TFlow(cfg=FlowNetConfig(**torch_ref.SMALL_NET))
    variables = jax.tree.map(jnp.asarray, torch_ref.load_npz_variables())
    jcfg, _ = _configs(N_FUSED, "SSF", False, FUSED_STEP)
    with pltpu.force_tpu_interpret_mode():
        _, outs = run_sequences_sharded(_fused_seqs(), jcfg, mesh,
                                        model=model, variables=variables)
    out = {k: np.asarray(outs[k]) for k in (*POSE_KEYS, "is_keyframe")}

    batch, lw = _train_batch()
    model = TFlow(cfg=FlowNetConfig(**{**torch_ref.SMALL_NET, **XLA_NET}))
    keep = optax.GradientTransformation(
        lambda p: jax.tree.map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g), g))
    state = TrainState(variables["params"], variables["batch_stats"],
                       keep.init(variables["params"]), jnp.int32(0))
    step = make_sharded_train_step(
        model, keep, mesh, TrainConfig(batch_size=len(batch["pos1"])),
        LossConfig(seg_class_weights=lw))
    with pltpu.force_tpu_interpret_mode():
        state, m = step(state, shard_batch(batch, mesh))
    grads = torch_ref.flatten({"params": state.opt_state})
    out.update(
        train_loss=np.float32(m["loss"]),
        **{f"grad_norm/{k}": np.float64(np.linalg.norm(v))
           for k, v in grads.items()},
        **{f"grad_sketch/{k}": np.float32(torch_ref.count_sketch(v, k))
           for k, v in grads.items()},
        **torch_ref.flatten({"batch_stats": state.batch_stats}))
    np.savez(path, **out)
    print(f"wrote {path}: loss {float(m['loss']):.6f}, keyframes "
          f"{out['is_keyframe'].astype(int).tolist()}")


def _spawn(fn, *args, world=D):
    from ssf_slam_tpu_torch.parallel.mesh import spawn

    return spawn(fn, world, "cpu", args, timeout=SPAWN_TIMEOUT)


def test_make_mesh_and_shard_batch_in_one_process():
    """Outside ``spawn``, ``make_mesh`` joins a world of one process; the
    mesh's ``shard_batch`` is then the whole batch, and a second backend is
    refused rather than taken instead."""
    import torch.distributed as dist

    from ssf_slam_tpu_torch.parallel.mesh import make_mesh, shard_batch

    if dist.is_initialized():
        pytest.skip("a process group is already up in this process")
    mesh = make_mesh(device="cpu")
    try:
        assert (mesh.rank, mesh.world_size, mesh.device.type) == (0, 1,
                                                                  "cpu")
        batch = {"a": np.arange(12, dtype=np.float32).reshape(4, 3)}
        np.testing.assert_array_equal(shard_batch(batch, mesh)["a"].numpy(),
                                      batch["a"])
        with pytest.raises(ValueError):
            make_mesh(2, device="cpu")
        if torch.cuda.is_available():
            pytest.skip("NCCL is there to be asked for")
        with pytest.raises(RuntimeError):
            make_mesh(device="cuda")
    finally:
        dist.destroy_process_group()


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 1 failed"):
        _spawn(workers.fail_on_rank, 1)


def test_shard_batch_splits_contiguously():
    parts = _spawn(workers.shard, {"a": np.arange(8.0).reshape(4, 2)})
    np.testing.assert_array_equal(parts[0]["a"], [[0, 1], [2, 3]])
    np.testing.assert_array_equal(parts[1]["a"], [[4, 5], [6, 7]])


def test_sequences_sharded_matches_jax():
    from ssf_slam_tpu import config as jc
    from ssf_slam_tpu.data.synthetic import generate_sequence
    from ssf_slam_tpu.parallel.mesh import make_mesh as jmesh
    from ssf_slam_tpu.parallel.mesh import run_sequences_sharded as jrun
    from ssf_slam_tpu_torch import config as tc

    def build(mod):
        return mod.PipelineConfig(
            variant=mod.Variant.SEG,
            features=mod.FeatureConfig(max_features=512),
            mapping=mod.MappingConfig(max_keyframes=16, submap_points=512,
                                      icp_iters=4, loop_submap_halfwidth=2))

    def traj(k):
        return np.array([1.0 * k, 0.0, 1.8]), 0.0

    jcfg, cfg = build(jc), build(tc)
    seqs = _pad([generate_sequence(n_frames=4, n_points=2048, seed=s,
                                   trajectory=traj) for s in (0, 1)],
                cfg.lidar.max_points)
    _, want = jrun(seqs, jcfg, jmesh(D))
    results = _spawn(workers.sequences, seqs, cfg, False)
    n_states, got = results[0]
    assert n_states == D and got["pose_t"].shape == (D, 4, 3)
    for _, other in results[1:]:  # every rank holds every sequence
        for k, v in got.items():
            np.testing.assert_array_equal(other[k], v)
    for key in ("pose_t", "odom_t"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   atol=T_TOL, err_msg=key)
    _assert_keyframes_equal_off_the_gate(got, want,
                                         cfg.mapping.keyframe_trans_gate)
    assert not np.allclose(got["pose_t"][0], got["pose_t"][1])


@pytest.fixture(scope="module")
def fused_sharded():
    _, cfg = _configs(N_FUSED, "SSF", False, FUSED_STEP)
    seqs = _fused_seqs()
    results = _spawn(workers.sequences, seqs, cfg, True)
    with np.load(SHARDED_REF) as z:
        want = {k: z[k] for k in z.files}
    return dict(seqs=seqs, cfg=cfg, results=results, want=want)


def test_fused_sharded_matches_jax(fused_sharded):
    results, want = fused_sharded["results"], fused_sharded["want"]
    n_states, got = results[0]
    assert n_states == D
    assert got["pose_t"].shape == (D, N_FUSED_FRAMES, 3)
    assert got["flow"].shape == (D, N_FUSED_FRAMES, N_FUSED, 4)
    for key in POSE_KEYS:
        tol = T_TOL if key.endswith("_t") else Q_TOL
        np.testing.assert_allclose(got[key], want[key], atol=tol,
                                   err_msg=key)
    np.testing.assert_array_equal(got["is_keyframe"], want["is_keyframe"])


@pytest.mark.parametrize("member", range(D))
def test_fused_sharded_member_matches_alone(fused_sharded, member):
    """A rank's sequence equals ``run_sequence_fused`` of it alone under
    the box of both sequences."""
    from ssf_slam_tpu_torch.engine.fused import (
        run_sequence_fused,
        sequence_box,
        stack_fused_scans,
    )

    seqs = fused_sharded["seqs"]
    box = sequence_box(np.concatenate(
        [stack_fused_scans(s, N_FUSED)["points"].reshape(-1, 3)
         for s in seqs]))
    model = workers._small_model()
    with pytest.MonkeyPatch.context() as mp:
        torch_ref.round_knn_like_xla_cpu(mp)
        alone = run_sequence_fused(model, seqs[member], fused_sharded["cfg"],
                                   device="cpu", box=box)
    got = {k: v[member] for k, v in fused_sharded["results"][0][1].items()}
    for key in ("pose_t", "odom_t", "rel_t"):
        np.testing.assert_allclose(got[key], alone[key], atol=ALONE_TOL,
                                   err_msg=key)
    np.testing.assert_array_equal(got["is_keyframe"], alone["is_keyframe"])
    np.testing.assert_allclose(got["flow"], alone["flow"], atol=ALONE_TOL)


@pytest.mark.parametrize("net", ["xla", "banded"])
@pytest.mark.parametrize("depth", [1, 2])
def test_sharded_streaming_matches_batch(tmp_path, depth, net):
    """The streamed outputs equal the batch run's: on the exact path (JAX's
    own test's backend) at that test's 1e-3 m, on the banded path, with
    the batch run under the stream's anchored box (the first block plus
    100 m), within 1e-5 m. A stripe of this rank's stream alone gives what
    the whole stripe gives: the box from the ranks' first blocks is the
    same."""
    from ssf_slam_tpu_torch.data.ssfb import native_available, write_ssfb

    if not native_available():
        pytest.skip("no C++ compiler for the ssfb loader")
    _, cfg = _configs(N_FUSED, "SSF", False, FUSED_STEP)
    seqs = [s[:3] for s in _fused_seqs()]
    paths = []
    for b, frames in enumerate(seqs):
        paths.append(str(tmp_path / f"s{b}.ssfb"))
        write_ssfb(frames, paths[-1])
    results = _spawn(workers.streaming, paths, seqs, cfg, depth,
                     XLA_NET if net == "xla" else None)
    batch, stream, stats, own = results[0]
    assert stats["n_scans"] == 3 and stats["n_seqs"] == D
    assert stats["latency_ms_mean"] > 0 and stats["hz_per_seq"] > 0
    assert stream["pose_t"].shape == (D, 3, 3)
    for _, other, _, other_own in results[1:]:
        np.testing.assert_array_equal(other["pose_t"], stream["pose_t"])
        np.testing.assert_array_equal(other_own["pose_t"], stream["pose_t"])
    for k, v in stream.items():
        np.testing.assert_array_equal(own[k], v, err_msg=k)
    if net == "xla":
        np.testing.assert_allclose(stream["pose_t"], batch["pose_t"],
                                   rtol=1e-3, atol=1e-3)
    else:
        for key in ("pose_t", "odom_t", "rel_t"):
            np.testing.assert_allclose(stream[key], batch[key],
                                       atol=ALONE_TOL, err_msg=key)
        np.testing.assert_array_equal(stream["is_keyframe"],
                                      batch["is_keyframe"])


@pytest.fixture(scope="module")
def sharded_train():
    """The capturing step at D = 2 and in one process, the optax chain's
    step at D = 2 and in one process."""
    from ssf_slam_tpu_torch.config import LossConfig, TrainConfig
    from ssf_slam_tpu_torch.train.trainer import (
        TrainState,
        create_train_state,
        make_train_step,
        to_device,
    )
    from ssf_slam_tpu_torch.weights import to_flax

    batch, lw = _train_batch()
    loss_cfg = LossConfig(seg_class_weights=lw)
    tcfg = TrainConfig(batch_size=len(batch["pos1"]))
    whole = to_device(batch, "cpu")
    # one process: the capturing optimizer, then the optax chain
    model = workers._small_model().train()
    state = TrainState(model, workers.CaptureState())
    state, m = make_train_step(model, workers.Capture(), tcfg, loss_cfg)(
        state, whole)
    one = dict(loss=float(m["loss"]),
               grads=to_flax(model, state.opt_state.grads),
               stats={k: v for k, v in to_flax(model).items()
                      if k.startswith("batch_stats/")})
    model = workers._small_model().train()
    state, tx = create_train_state(model, tcfg)
    state, m = make_train_step(model, tx, tcfg, loss_cfg)(state, whole)
    one.update(step_loss=float(m["loss"]), after=to_flax(model))
    return dict(one=one, capture=_spawn(workers.train_step, batch, lw, True),
                chain=_spawn(workers.train_step, batch, lw, False),
                xla=_spawn(workers.train_step, batch, lw, True, XLA_NET))


def test_sharded_train_step_matches_one_process(sharded_train):
    one = sharded_train["one"]
    # each averaged gradient leaf within 1e-5 of its norm of the one
    # process's, plus tests/test_torch_train.py's floor of 1e-6 of the
    # largest leaf's norm (the few leaves near zero; this host reads at
    # most 1.9e-5 of a norm against 1e-5 plus the floor)
    norms = {k: float(np.linalg.norm(v)) for k, v in one["grads"].items()}
    floor = 1e-6 * max(norms.values())
    for rank, (loss, grads, stats, _, _) in enumerate(
            sharded_train["capture"]):
        assert loss == pytest.approx(one["loss"], rel=1e-6), rank
        for k, v in stats.items():
            np.testing.assert_allclose(v, one["stats"][k], rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        assert grads.keys() == norms.keys()
        for k, g in grads.items():
            err = float(np.linalg.norm(g - one["grads"][k]))
            assert err <= 1e-5 * norms[k] + floor, (rank, k, err, norms[k])
    # the optax chain's step: the ranks' parameters are equal bit for bit,
    # and equal the one process's within 1e-6 wherever Adam's first step
    # is not decided by rounding. Its update is lr u(g') with u(x) = x /
    # (|x| + eps), of the effective gradient g' = clip * g + weight_decay
    # * p; the clip (the global norm is ~93 against 5) and the decay make
    # |g'| small against eps for many elements, and there u turns the
    # half-batch sums' rounding of g into differences of the update
    # (ROADMAP §3, Adam's first step). Held where the two runs' captured
    # gradients give updates within 1e-7 of each other.
    from ssf_slam_tpu_torch.config import TrainConfig
    from ssf_slam_tpu_torch.weights import to_flax

    (loss0, after0), (loss1, after1) = sharded_train["chain"]
    assert loss0 == loss1 == pytest.approx(one["step_loss"], rel=1e-6)
    tcfg = TrainConfig()
    before = to_flax(workers._small_model())
    sharded_grads = sharded_train["capture"][0][1]

    def updates(grads):
        norm = np.sqrt(sum(np.sum(np.asarray(g, np.float64) ** 2)
                           for g in grads.values()))
        out = {}
        for k, g in grads.items():
            g = min(1.0, 5.0 / norm) * np.asarray(g, np.float64) \
                + tcfg.weight_decay * np.asarray(before[k], np.float64)
            out[k] = tcfg.lr * g / (np.abs(g) + 1e-8)
        return out

    u_sharded, u_one = updates(sharded_grads), updates(one["grads"])

    n_held = n_all = 0
    for k, v in after0.items():
        np.testing.assert_array_equal(after1[k], v, err_msg=k)
        want = one["after"][k]
        if k.startswith("params/"):
            held = np.abs(u_sharded[k] - u_one[k]) <= 1e-7
            n_held, n_all = n_held + held.sum(), n_all + held.size
            np.testing.assert_allclose(v[held], want[held], atol=1e-6,
                                       rtol=0, err_msg=k)
        else:
            np.testing.assert_allclose(v, want, rtol=1e-6, atol=1e-6,
                                       err_msg=k)
    assert n_held >= 0.95 * n_all, (n_held, n_all)


def test_sharded_train_step_matches_jax(sharded_train):
    with np.load(SHARDED_REF) as z:
        want = {k: z[k] for k in z.files}
    loss, grads, stats, flipped, n_edge = sharded_train["xla"][0]
    assert loss == pytest.approx(float(want["train_loss"]), rel=1e-5)
    for k, v in stats.items():
        np.testing.assert_allclose(v, want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    norms = {k[len("grad_norm/"):]: float(v) for k, v in want.items()
             if k.startswith("grad_norm/")}
    assert grads.keys() == norms.keys()
    # the knife-edge allowance of tests/test_torch_train.py: what the
    # activations within rounding of zero move, on the leaves they reach
    assert n_edge < 1000, n_edge
    floor = 1e-6 * max(norms.values())
    for k, w in norms.items():
        edge = flipped[k] - grads[k]
        assert abs(np.linalg.norm(grads[k]) - w) <= 1e-4 * w + floor \
            + np.linalg.norm(edge), k
        err = np.linalg.norm(torch_ref.count_sketch(grads[k], k)
                             - want[f"grad_sketch/{k}"])
        slack = np.linalg.norm(torch_ref.count_sketch(edge, k))
        assert err <= 1e-4 * w + floor + slack, (k, err, w, slack)


if __name__ == "__main__" and "--make-fixture" in sys.argv:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
    make_fixture()
