"""Many sequences on one card (``ssf_slam_tpu_torch/parallel/mesh.py``)
against the JAX package, on the CPU.

- ``run_sequences_batched`` (no model) live against JAX's
  ``run_sequences_batched(seqs, cfg)`` without a mesh, in
  tests/test_parallel.py::test_sequences_batched's configuration (SEG, 2
  sequences x 4 frames x 2048 points padded to ``max_points``): pose_t and
  odom_t within 1e-4 m, is_keyframe equal but where the trajectory's
  1.0 m a frame meets the 1.0 m keyframe gate within 1e-5 m (the two
  packages' float32 rounding decides those frames).
- ``run_sequences_fused_batched`` at B = 2 (4 frames x 1024 points, the
  small TFlow of ``torch_ref.SMALL_NET`` with the committed weights, f32,
  banded, the small SLAM step without loop closure and scan-to-map
  refine, as scripts/batch_economics.py runs it) against a committed JAX
  run (``batched_small_ref.npz``: ``vmap`` of ``make_fused_step``'s step
  under one shared ``sequence_box``, as batch_economics.py:61-80 builds it,
  Pallas in interpret mode): poses within 1e-4 m / 1e-5, is_keyframe
  equal; and each member against the port's ``run_sequence_fused`` of
  that member alone under the shared box within 1e-5 m.

The fixture is made by

    JAX_PLATFORMS=cpu python tests/test_torch_parallel.py --make-fixture
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ref  # noqa: E402
from test_torch_variants import (  # noqa: E402
    POSE_KEYS,
    Q_TOL,
    SMALL_STEP,
    T_TOL,
    _configs,
)

torch.set_num_threads(1)

BATCHED_REF = os.path.join(torch_ref.FIXTURE_DIR, "batched_small_ref.npz")
N_FUSED, N_FUSED_FRAMES, B = 1024, 4, 2
ALONE_TOL = 1e-5
GATE_EPS = 1e-5  # m: a keyframe gate decided by rounding
# batch_economics.py's mapping: no loop closure, no scan-to-map refine
FUSED_STEP = dict(SMALL_STEP, mapping=dict(
    SMALL_STEP["mapping"], enable_loop_closure=False,
    scan_to_map_refine=False))


@pytest.fixture(autouse=True)
def _xla_cpu_knn(monkeypatch):
    torch_ref.round_knn_like_xla_cpu(monkeypatch)


def _fused_seqs():
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    return [generate_sequence(n_frames=N_FUSED_FRAMES, n_points=N_FUSED,
                              seed=100 + b, noise=0.004, n_moving=4)
            for b in range(B)]


def make_fixture(path: str = BATCHED_REF) -> None:
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ssf_slam_tpu.config import FlowNetConfig
    from ssf_slam_tpu.engine.fused import (
        make_fused_step,
        sequence_box,
        stack_fused_scans,
    )
    from ssf_slam_tpu.models import TFlow

    jcfg, _ = _configs(N_FUSED, "SSF", False, FUSED_STEP)
    model = TFlow(cfg=FlowNetConfig(**torch_ref.SMALL_NET))
    variables = jax.tree.map(jnp.asarray, torch_ref.load_npz_variables())
    stacked = [stack_fused_scans(seq, N_FUSED) for seq in _fused_seqs()]
    scans = {k: jnp.stack([s[k] for s in stacked]) for k in stacked[0]}
    box = sequence_box(np.asarray(scans["points"]))
    fused_step, _, make_carry = make_fused_step(model, variables, jcfg,
                                                box=box)

    def one_sequence(seq_scans):
        carry = make_carry(seq_scans["prev"][0])
        return jax.lax.scan(fused_step, carry, seq_scans)

    with pltpu.force_tpu_interpret_mode():
        _, outs = jax.jit(jax.vmap(one_sequence))(scans)
    out = {k: np.asarray(outs[k]) for k in (*POSE_KEYS, "is_keyframe")}
    out.update(box_origin=np.asarray(box[0]), box_scale=np.asarray(box[1]))
    print(f"  keyframes {out['is_keyframe'].astype(int).tolist()}")
    np.savez(path, **out)
    print(f"wrote {path}")


def _pad(seqs, n: int):
    """Pad every point array to ``n`` rows, as test_sequences_batched
    does."""
    for seq in seqs:
        for f in seq:
            for key in ("pos1", "pos2", "gt", "ego_flow"):
                pad = np.zeros((n, 3), np.float32)
                pad[:len(f[key])] = f[key]
                f[key] = pad
            for key in ("s_fg_mask", "t_fg_mask", "mask1", "mask2"):
                pad = np.zeros(n, f[key].dtype)
                pad[:len(f[key])] = f[key]
                f[key] = pad
    return seqs


def _assert_keyframes_equal_off_the_gate(got, want, gate: float) -> None:
    """is_keyframe equal, except where the translation since the last
    keyframe lies within GATE_EPS of the gate: this configuration's
    trajectory moves exactly ``keyframe_trans_gate`` (1.0 m) a frame, so
    there the two packages' float32 rounding of the ego-motion (a few
    1e-7 m) decides the gate (ROADMAP §3)."""
    kf_got, kf_want = got["is_keyframe"], np.asarray(want["is_keyframe"])
    pose_t = np.asarray(want["pose_t"])
    for b, s in zip(*np.nonzero(kf_got != kf_want)):
        last = max(k for k in range(s) if kf_want[b, k])
        moved = np.linalg.norm(pose_t[b, s] - pose_t[b, last])
        assert abs(moved - gate) < GATE_EPS, (b, s, moved)
    # the knife edge is rare: most frames agree
    assert (kf_got == kf_want).mean() >= 0.75


def test_sequences_batched_matches_jax():
    from ssf_slam_tpu import config as jc
    from ssf_slam_tpu.data.synthetic import generate_sequence
    from ssf_slam_tpu.parallel.mesh import run_sequences_batched as jrun
    from ssf_slam_tpu_torch import config as tc
    from ssf_slam_tpu_torch.parallel.mesh import run_sequences_batched

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
    _, want = jrun(seqs, jcfg)
    states, got = run_sequences_batched(seqs, cfg, device="cpu")
    assert len(states) == 2 and got["pose_t"].shape == (2, 4, 3)
    for key in ("pose_t", "odom_t"):
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   atol=T_TOL, err_msg=key)
    _assert_keyframes_equal_off_the_gate(got, want,
                                         cfg.mapping.keyframe_trans_gate)
    # the two sequences really differ
    assert not np.allclose(got["pose_t"][0], got["pose_t"][1])


@pytest.fixture(scope="module")
def fused_batched():
    """The port's batched run at B = 2 (plain versions of the kernels),
    the shared box and the frames."""
    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.ops import banded
    from ssf_slam_tpu_torch.parallel.mesh import run_sequences_fused_batched
    from ssf_slam_tpu_torch.weights import load_tflow

    with np.load(BATCHED_REF) as z:
        want = {k: z[k] for k in z.files}
    seqs = _fused_seqs()
    _, cfg = _configs(N_FUSED, "SSF", False, FUSED_STEP)
    model = load_tflow(FlowNetConfig(**torch_ref.SMALL_NET), device="cpu")
    box = (torch.from_numpy(want["box_origin"]),
           torch.from_numpy(want["box_scale"]))
    banded.reset_launches()
    with pytest.MonkeyPatch.context() as mp:
        torch_ref.round_knn_like_xla_cpu(mp)
        states, got = run_sequences_fused_batched(model, seqs, cfg,
                                                  device="cpu")
    assert sum(banded.LAUNCHES.values()) == 0  # the plain versions
    return dict(model=model, seqs=seqs, cfg=cfg, box=box, got=got,
                want=want, states=states)


def test_fused_batched_matches_jax(fused_batched):
    from ssf_slam_tpu_torch.engine.fused import sequence_box, stack_fused_scans

    got, want = fused_batched["got"], fused_batched["want"]
    # the default box is the one JAX took over both sequences
    pts = np.stack([stack_fused_scans(s, N_FUSED)["points"]
                    for s in fused_batched["seqs"]])
    box = sequence_box(pts)
    np.testing.assert_array_equal(box[0].numpy(), want["box_origin"])
    np.testing.assert_array_equal(box[1].numpy(), want["box_scale"])
    assert len(fused_batched["states"]) == B
    assert got["pose_t"].shape == (B, N_FUSED_FRAMES, 3)
    assert got["flow"].shape == (B, N_FUSED_FRAMES, N_FUSED, 4)
    assert 0 < got["is_keyframe"].sum()
    for key in POSE_KEYS:
        tol = T_TOL if key.endswith("_t") else Q_TOL
        np.testing.assert_allclose(got[key], want[key], atol=tol,
                                   err_msg=key)
    np.testing.assert_array_equal(got["is_keyframe"], want["is_keyframe"])


@pytest.mark.parametrize("member", range(B))
def test_fused_batched_member_matches_alone(fused_batched, member):
    from ssf_slam_tpu_torch.engine.fused import run_sequence_fused

    alone = run_sequence_fused(fused_batched["model"],
                               fused_batched["seqs"][member],
                               fused_batched["cfg"], device="cpu",
                               box=fused_batched["box"])
    got = {k: v[member] for k, v in fused_batched["got"].items()}
    for key in ("pose_t", "odom_t", "rel_t"):
        np.testing.assert_allclose(got[key], alone[key], atol=ALONE_TOL,
                                   err_msg=key)
    np.testing.assert_array_equal(got["is_keyframe"], alone["is_keyframe"])
    np.testing.assert_allclose(got["flow"], alone["flow"], atol=ALONE_TOL)


def test_batch_economics_measures_each_batch():
    """The port's batch_economics at a small size on the CPU: one row a
    batch, the kernels' counters at zero (the plain versions), finite
    poses, and the table."""
    from ssf_slam_tpu_torch.parallel import batch_economics as be

    seqs = _fused_seqs()
    _, cfg = _configs(N_FUSED, "SSF", False, FUSED_STEP)
    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.weights import load_tflow

    model = load_tflow(FlowNetConfig(**torch_ref.SMALL_NET), device="cpu")
    rows = be.measure(model, [s[:3] for s in seqs], cfg, batches=(1, 2),
                      repeats=1, device="cpu")
    assert [r["b"] for r in rows] == [1, 2]
    for r in rows:
        assert r["finite"] and r["launches"] == {} and r["peak_mib"] is None
        assert len(r["ate"]) == r["b"] and r["lo"] <= r["median"] <= r["hi"]
    assert be.table(rows).splitlines()[2].endswith("| 1.00x |")
    assert be.row_line(rows[1]).startswith("B=2: aggregate ")


if __name__ == "__main__":
    if sys.argv[1:] != ["--make-fixture"]:
        sys.exit("usage: python tests/test_torch_parallel.py --make-fixture")
    import jax

    jax.config.update("jax_platforms", "cpu")
    make_fixture()
