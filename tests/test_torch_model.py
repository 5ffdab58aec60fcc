"""The port's TFlow against the JAX TFlow, float32, committed weights.

A small config where the banded path really fires (npoint=1024,
sa_npoints=(512, 256, 128, 64)): the level-0 cost volume and warping meet
band_params at 1024 * 1024 = 2^20, so all four banded kernels run (their
plain versions on the CPU; Pallas in interpret mode on the JAX side). The
inputs are two consecutive frames of the synthetic street sequence.

Tolerances: the per-level flows and the seg logit agree to 1e-3 absolute
(flows of ~1 m, logits of ~10): both sides are float32 and pick the same
neighbours; the differences are matmul and softmax sum orders compounded
through four refinement levels. The mean end-point difference of the finest
flow is held to 1e-4 m.

The JAX side is committed (``tflow_small_ref.npz``, with the
``fuse_attention=True`` flows that tests/test_torch_attention.py reads):
live, its interpret-mode Pallas compile, which JAX's persistent cache
cannot keep, cost the suite a minute per file. It is made by

      JAX_PLATFORMS=cpu python tests/test_torch_model.py --make-fixture
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

ATOL = 1e-3
TFLOW_REF = os.path.join(torch_ref.FIXTURE_DIR, "tflow_small_ref.npz")


def small_pair():
    """Frames 0 and 1 of the street sequence, seed 3, 1024 points."""
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    f = generate_sequence(n_frames=2, n_points=1024, seed=3, noise=0.004,
                          n_moving=4)
    return f[0]["pos1"][None], f[1]["pos1"][None]


def make_fixture(path: str = TFLOW_REF) -> None:
    """The JAX TFlow's flows and FPS chain on ``small_pair`` (float32,
    committed weights, Pallas in interpret mode), and its flows with
    ``fuse_attention=True``."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ssf_slam_tpu.config import FlowNetConfig
    from ssf_slam_tpu.models import TFlow

    variables = jax.tree.map(jnp.asarray, torch_ref.load_npz_variables())
    out = {}
    pair = [jnp.asarray(a) for a in small_pair()]
    with pltpu.force_tpu_interpret_mode():
        for fused in (False, True):
            net = dict(torch_ref.SMALL_NET, fuse_attention=fused)
            model = TFlow(cfg=FlowNetConfig(**net))
            flows, fps = jax.jit(model.apply)(variables, *pair)
            pre = "fused_flow" if fused else "flow"
            out.update({f"{pre}{i}": np.asarray(f)
                        for i, f in enumerate(flows)})
            if not fused:
                out.update({f"fps{i}": np.asarray(x)
                            for i, x in enumerate(fps)})
    np.savez(path, **out)
    print(f"wrote {path}")


@pytest.fixture(scope="module")
def pair():
    return small_pair()


@pytest.fixture(scope="module")
def jax_out():
    with np.load(TFLOW_REF) as z:
        return ([z[f"flow{i}"] for i in range(4)],
                [z[f"fps{i}"] for i in range(3)])


@pytest.fixture(scope="module")
def torch_out(pair):
    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.ops import banded
    from ssf_slam_tpu_torch.weights import load_tflow

    model = load_tflow(FlowNetConfig(**torch_ref.SMALL_NET), device="cpu")
    banded.reset_launches()
    with torch.inference_mode():
        flows, fps = model(*map(torch.from_numpy, pair))
    assert sum(banded.LAUNCHES.values()) == 0  # CPU: plain versions only
    return [f.numpy() for f in flows], [i.numpy() for i in fps]


def test_fps_chain_equal(jax_out, torch_out):
    for j, t in zip(jax_out[1], torch_out[1]):
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_level_flows_and_seg_logit(jax_out, torch_out, level):
    j, t = jax_out[0][level], torch_out[0][level]
    assert t.shape == j.shape and t.shape[-1] == 4
    assert np.isfinite(t).all()
    np.testing.assert_allclose(t[..., :3], j[..., :3], atol=ATOL)
    np.testing.assert_allclose(t[..., 3], j[..., 3], atol=ATOL)


def test_finest_flow_end_point_difference(jax_out, torch_out):
    j, t = jax_out[0][0], torch_out[0][0]
    epe = np.linalg.norm(t[..., :3] - j[..., :3], axis=-1).mean()
    assert epe < 1e-4, epe
    # the static / moving verdict the ego-motion uses
    assert ((t[..., 3] < 0) == (j[..., 3] < 0)).mean() > 0.999


if __name__ == "__main__":
    if sys.argv[1:] != ["--make-fixture"]:
        sys.exit("usage: python tests/test_torch_model.py --make-fixture")
    import jax

    jax.config.update("jax_platforms", "cpu")
    make_fixture()
