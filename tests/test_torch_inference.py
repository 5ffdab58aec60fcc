"""The port's inference helpers (models/inference.py) against the JAX
package's, on the CPU: the small TFlow with the committed weights on the
exact ("xla") neighbour backend, so that no Pallas kernel runs.

``predict_flow_resampled`` draws its permutations with ``jax.random`` in
the JAX package; the test draws the same ones as that function does
(``jax.random.split`` then ``jax.random.permutation``) and hands them to
the port's function, whose output must match the JAX function's within
1e-4.
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

NET = dict(torch_ref.SMALL_NET, neighbor_backend="xla")
N, R, SEED = 1024, 3, 7
TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    f = generate_sequence(n_frames=2, n_points=N, seed=2, noise=0.004,
                          n_moving=4)[1]
    return (f["pos1"][None].astype(np.float32),
            f["pos2"][None].astype(np.float32))


@pytest.fixture(scope="module")
def nets():
    import jax
    import jax.numpy as jnp

    from ssf_slam_tpu.config import FlowNetConfig as JConfig
    from ssf_slam_tpu.models import TFlow as JTFlow
    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.weights import load_tflow

    variables = jax.tree.map(jnp.asarray, torch_ref.load_npz_variables())
    return (JTFlow(cfg=JConfig(**NET)), variables,
            load_tflow(FlowNetConfig(**NET), device="cpu"))


def test_predict_flow_matches_jax(pair, nets):
    import jax
    import jax.numpy as jnp

    from ssf_slam_tpu.models.inference import predict_flow as jpredict
    from ssf_slam_tpu_torch.models.inference import predict_flow

    jmodel, variables, model = nets
    want = np.asarray(jax.jit(lambda a, b: jpredict(jmodel, variables, a, b))(
        *map(jnp.asarray, pair)))
    with torch.inference_mode():
        got = predict_flow(model, *map(torch.from_numpy, pair)).numpy()
    assert got.shape == (1, N, 4)
    np.testing.assert_allclose(got, want, atol=TOL)


def test_predict_flow_resampled_matches_jax(pair, nets):
    import jax
    import jax.numpy as jnp

    from ssf_slam_tpu.models.inference import (
        predict_flow_resampled as jresampled,
    )
    from ssf_slam_tpu_torch.models.inference import predict_flow_resampled

    jmodel, variables, model = nets
    rng = jax.random.PRNGKey(SEED)
    # the permutations the JAX function draws from rng
    perms = np.asarray(jax.vmap(lambda k: jax.random.permutation(k, N))(
        jax.random.split(rng, R)))
    assert not np.array_equal(perms[0], perms[1])
    want = np.asarray(jax.jit(lambda a, b: jresampled(
        jmodel, variables, a, b, rng, n_resample=R))(
            *map(jnp.asarray, pair)))
    with torch.inference_mode():
        pc1, pc2 = map(torch.from_numpy, pair)
        got = predict_flow_resampled(model, pc1, pc2,
                                     perms=torch.from_numpy(perms)).numpy()
        # drawn from a generator: R members of the same shape, in order
        drawn = predict_flow_resampled(
            model, pc1, pc2, torch.Generator().manual_seed(0), n_resample=2)
    np.testing.assert_allclose(got, want, atol=TOL)
    assert drawn.shape == (1, N, 4) and torch.isfinite(drawn).all()
