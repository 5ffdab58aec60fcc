"""The ssfc variant (TFlow's flow, the SegNet classifier's static mask,
the seg-gated SLAM step) against the JAX package, on the CPU.

- The small ssfc fused step: 8 frames x 1024 points, the small TFlow with
  the committed ``ssf_r3ft2`` weights and the default SegNet with the
  committed ``segnet_r3`` weights (f32, banded: sa1 and fp1 take the
  banded kNN at 1024 x 1024), the small SLAM step of
  tests/test_torch_variants.py, against a committed JAX run
  (``ssfc_small_ref.npz``, Pallas in interpret mode): poses within 1e-4 m
  / 1e-5, is_keyframe / n_features / n_dyn_over equal, and each frame's
  static mask equal to JAX's (the port's SegNet on the port's flow).
- The 8192-point fixture that the chip check holds on the card
  (``ssfc_ref.npz``: the committed weights of both nets, f32, the first 8
  bench frames, bench.py's step): here its frame-1 SegNet logits, the
  port's SegNet on the fixture's own flow, within 1e-4.

Both fixtures are made by

    JAX_PLATFORMS=cpu python tests/test_torch_ssfc.py --make-fixture [small|full]
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
from test_torch_variants import (  # noqa: E402
    EXACT_KEYS,
    POSE_KEYS,
    SMALL_STEP,
    _assert_run,
    _configs,
    bench_frames,
)

torch.set_num_threads(1)

SMALL_REF = os.path.join(torch_ref.FIXTURE_DIR, "ssfc_small_ref.npz")
FULL_REF = os.path.join(torch_ref.FIXTURE_DIR, "ssfc_ref.npz")
N_SMALL, N_SMALL_FRAMES = 1024, 8
N_FULL = 8192
FULL_NET = dict(npoint=N_FULL, joint_seg=True, neighbor_backend="banded")


@pytest.fixture(autouse=True)
def _xla_cpu_knn(monkeypatch):
    torch_ref.round_knn_like_xla_cpu(monkeypatch)


def _small_frames():
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    return generate_sequence(n_frames=N_SMALL_FRAMES, n_points=N_SMALL,
                             seed=0, noise=0.004, n_moving=4)


def _jax_nets(net: dict):
    """(TFlow, its variables, SegNet, its variables) of the JAX package,
    with the committed weights of both, f32, banded."""
    import jax
    import jax.numpy as jnp

    from ssf_slam_tpu.config import FlowNetConfig
    from ssf_slam_tpu.models import TFlow
    from ssf_slam_tpu.models.segnet import SegNet

    variables = jax.tree.map(jnp.asarray, torch_ref.load_npz_variables())
    seg_vars = jax.tree.map(jnp.asarray,
                            torch_ref.load_npz_variables(SEG_NPZ))
    return (TFlow(cfg=FlowNetConfig(**net)), variables,
            SegNet(n_classes=2, neighbor_backend="banded"), seg_vars)


def _jax_ssfc(frames, n_points: int, step: dict, net: dict,
              mask_frames=()) -> dict:
    """The JAX package's ``run_sequence_fused`` with ``seg_apply`` (Pallas
    in interpret mode), and for each frame k of ``mask_frames`` the flow of
    the pair (k-1, k) and the classifier's logits and static mask on it,
    computed as the fused step computes them."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ssf_slam_tpu.engine.fused import (
        run_sequence_fused,
        sequence_box,
        stack_fused_scans,
    )
    from ssf_slam_tpu.models import TFlow

    jcfg, _ = _configs(n_points, "SSF", False, step)
    model, variables, seg, seg_vars = _jax_nets(net)

    def seg_apply(pc, flow):
        return seg.apply(seg_vars, pc, flow)

    out = {}
    with pltpu.force_tpu_interpret_mode():
        _, outs = run_sequence_fused(model, variables, frames, jcfg,
                                     seg_apply=seg_apply)
        out.update({k: np.asarray(outs[k]) for k in (*POSE_KEYS,
                                                     *EXACT_KEYS)})
        scans = stack_fused_scans(frames, n_points)
        box = sequence_box(np.asarray(scans["points"]))
        out.update(box_origin=np.asarray(box[0]),
                   box_scale=np.asarray(box[1]))

        @jax.jit
        def pair(prev, points):
            towers = [model.apply(variables, pc[None], False, box,
                                  method=TFlow.tower)
                      for pc in (prev, points)]
            flows, _ = model.apply(variables, *towers, False, box,
                                   method=TFlow.head)
            flow = flows[0][0][:, :3].astype(jnp.float32)
            return flow, seg_apply(prev[None], flow[None])[0]

        for k in mask_frames:
            flow, logits = pair(scans["prev"][k], scans["points"][k])
            out[f"flow/{k}"] = np.asarray(flow)
            out[f"logits/{k}"] = np.asarray(logits)
            out[f"static/{k}"] = np.asarray(jnp.argmax(logits, -1) == 0)
    print(f"  keyframes {out['is_keyframe'].astype(int).tolist()}")
    return out


def make_small_fixture(path: str = SMALL_REF) -> None:
    out = _jax_ssfc(_small_frames(), N_SMALL, SMALL_STEP, torch_ref.SMALL_NET,
                    mask_frames=range(N_SMALL_FRAMES))
    np.savez(path, **out)
    print(f"wrote {path}")


def make_full_fixture(path: str = FULL_REF) -> None:
    """The card's f32 fixture: 8 bench frames x 8192 points, both nets'
    committed weights, bench.py's step (the default PipelineConfig)."""
    out = _jax_ssfc(bench_frames(), N_FULL, {}, FULL_NET, mask_frames=(1,))
    np.savez(path, **out)
    print(f"wrote {path}")


def _port_segnet():
    from ssf_slam_tpu_torch.weights import load_segnet

    return load_segnet(SEG_NPZ, dtype="float32", device="cpu")


def test_small_ssfc_fused_step_matches_jax():
    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.engine.fused import run_sequence_fused
    from ssf_slam_tpu_torch.ops import banded
    from ssf_slam_tpu_torch.weights import load_tflow

    with np.load(SMALL_REF) as z:
        want = {k: z[k] for k in z.files}
    frames = _small_frames()
    _, cfg = _configs(N_SMALL, "SSF", False, SMALL_STEP)
    model = load_tflow(FlowNetConfig(**torch_ref.SMALL_NET), device="cpu")
    seg = _port_segnet()
    banded.reset_launches()
    got = run_sequence_fused(model, frames, cfg, device="cpu", seg_apply=seg)
    assert sum(banded.LAUNCHES.values()) == 0  # the plain versions
    assert 0 < got["is_keyframe"].sum()
    _assert_run(got, want, N_SMALL_FRAMES, "ssfc")
    # each frame's static mask: the port's SegNet on the port's flow
    n_moving = 0
    with torch.inference_mode():
        for k in range(N_SMALL_FRAMES):
            prev = torch.from_numpy(frames[max(k - 1, 0)]["pos1"]
                                    .astype(np.float32))[None]
            flow = torch.from_numpy(got["flow"][k][:, :3].copy())[None]
            static = (seg(prev, flow)[0].argmax(-1) == 0).numpy()
            np.testing.assert_array_equal(static, want[f"static/{k}"],
                                          err_msg=f"frame {k}")
            # the flow may move by a few 1e-4 m at a handful of points
            # (neighbour near-ties of the packed kNN keys, ROADMAP §3)
            np.testing.assert_allclose(got["flow"][k][:, :3],
                                       want[f"flow/{k}"], atol=1e-3)
            n_moving += int((~static).sum())
    assert n_moving > 0  # the classifier splits the clouds


def test_full_width_segnet_logits_match_card_fixture():
    from ssf_slam_tpu_torch.ops import banded

    with np.load(FULL_REF) as z:
        ref = {k: z[k] for k in z.files}
    prev = torch.from_numpy(bench_frames(1)[0]["pos1"].astype(np.float32))
    seg = _port_segnet()
    banded.reset_launches()
    with torch.inference_mode():
        logits = seg(prev[None], torch.from_numpy(ref["flow/1"])[None])[0]
    assert sum(banded.LAUNCHES.values()) == 0
    np.testing.assert_allclose(logits.numpy(), ref["logits/1"], atol=1e-4)
    np.testing.assert_array_equal((logits.argmax(-1) == 0).numpy(),
                                  ref["static/1"])


if __name__ == "__main__":
    if sys.argv[1:] not in (["--make-fixture"], ["--make-fixture", "small"],
                            ["--make-fixture", "full"]):
        sys.exit("usage: python tests/test_torch_ssfc.py --make-fixture "
                 "[small|full]")
    import jax

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[2:] != ["full"]:
        make_small_fixture()
    if sys.argv[2:] != ["small"]:
        make_full_fixture()
