"""The port's inference helpers (models/inference.py) against the JAX
package's, on the CPU: the small TFlow with the committed weights on the
exact ("xla") neighbour backend, so that no Pallas kernel runs, and on the
banded backend against a committed JAX run.

``predict_flow_resampled`` draws its permutations with ``jax.random`` in
the JAX package; the test draws the same ones as that function does
(``jax.random.split`` then ``jax.random.permutation``) and hands them to
the port's function, whose output must match the JAX function's within
1e-4. On the banded backend (``resampled_banded_ref.npz``: JAX's ensemble
and each of its members with the same permutations, Pallas in interpret
mode) the port's ensemble and every member are held at the small TFlow's
tolerance (tests/test_torch_model.py: 1e-3 absolute, mean end-point
difference 1e-4 m), and the members' spread to JAX's. The fixture is made
by

    JAX_PLATFORMS=cpu python tests/test_torch_inference.py --make-fixture
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
BANDED_REF = os.path.join(torch_ref.FIXTURE_DIR, "resampled_banded_ref.npz")
BANDED_ATOL, BANDED_EPE = 1e-3, 1e-4  # tests/test_torch_model.py's


def _pair():
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    f = generate_sequence(n_frames=2, n_points=N, seed=2, noise=0.004,
                          n_moving=4)[1]
    return (f["pos1"][None].astype(np.float32),
            f["pos2"][None].astype(np.float32))


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _jax_perms():
    """The permutations ``predict_flow_resampled`` draws from
    PRNGKey(SEED)."""
    import jax

    rng = jax.random.PRNGKey(SEED)
    return rng, np.asarray(jax.vmap(lambda k: jax.random.permutation(k, N))(
        jax.random.split(rng, R)))


def make_fixture(path: str = BANDED_REF) -> None:
    """JAX's ensemble on the banded backend and each member's flow put
    back into the input order (Pallas in interpret mode)."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ssf_slam_tpu.config import FlowNetConfig as JConfig
    from ssf_slam_tpu.models import TFlow as JTFlow
    from ssf_slam_tpu.models.inference import (
        predict_flow_resampled as jresampled,
    )

    model = JTFlow(cfg=JConfig(**torch_ref.SMALL_NET))
    variables = jax.tree.map(jnp.asarray, torch_ref.load_npz_variables())
    pc1, pc2 = map(jnp.asarray, _pair())
    rng, perms = _jax_perms()

    @jax.jit
    def member(perm):
        flows, _ = model.apply(variables, jnp.take(pc1, perm, axis=1), pc2)
        return jnp.take(flows[0], jnp.argsort(perm), axis=1)

    with pltpu.force_tpu_interpret_mode():
        ens = np.asarray(jax.jit(lambda a, b: jresampled(
            model, variables, a, b, rng, n_resample=R))(pc1, pc2))
        members = np.stack([np.asarray(member(jnp.asarray(p)))
                            for p in perms])
    np.savez(path, perms=perms, ensemble=ens, members=members)
    print(f"wrote {path}: member spread {_spread(members)}")


def _spread(members: np.ndarray) -> tuple[float, float]:
    """(mean, max) end-point distance of members 1.. from member 0."""
    d = np.linalg.norm(members[1:, ..., :3] - members[:1, ..., :3], axis=-1)
    return float(d.mean()), float(d.max())


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


def _assert_flow(got: np.ndarray, want: np.ndarray, what: str) -> None:
    np.testing.assert_allclose(got, want, atol=BANDED_ATOL, err_msg=what)
    epe = np.linalg.norm(got[..., :3] - want[..., :3], axis=-1).mean()
    assert epe <= BANDED_EPE, (what, epe)


def test_predict_flow_resampled_banded_matches_jax(pair):
    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.models.inference import (
        predict_flow,
        predict_flow_resampled,
    )
    from ssf_slam_tpu_torch.ops import banded
    from ssf_slam_tpu_torch.weights import load_tflow

    with np.load(BANDED_REF) as z:
        want = {k: z[k] for k in z.files}
    _, perms = _jax_perms()
    np.testing.assert_array_equal(perms, want["perms"])
    model = load_tflow(FlowNetConfig(**torch_ref.SMALL_NET), device="cpu")
    pc1, pc2 = map(torch.from_numpy, pair)
    banded.reset_launches()
    with torch.inference_mode():
        ens = predict_flow_resampled(model, pc1, pc2,
                                     perms=torch.from_numpy(perms)).numpy()
        members = np.stack([
            predict_flow(model, pc1[:, p], pc2)[:, np.argsort(p)].numpy()
            for p in torch.from_numpy(perms)])
    assert sum(banded.LAUNCHES.values()) == 0  # the plain versions
    _assert_flow(ens, want["ensemble"], "ensemble")
    for r in range(R):
        _assert_flow(members[r], want["members"][r], f"member {r}")
    # the members differ by the same amount in both packages: the spread
    # is the ensemble's own (the FPS of a reordered cloud), not the port's
    got_spread, want_spread = _spread(members), _spread(want["members"])
    assert want_spread[1] > 10 * BANDED_EPE  # the members do differ
    assert got_spread[0] == pytest.approx(want_spread[0], rel=0.05)
    assert got_spread[1] == pytest.approx(want_spread[1], rel=0.05)


if __name__ == "__main__":
    if sys.argv[1:] != ["--make-fixture"]:
        sys.exit("usage: python tests/test_torch_inference.py --make-fixture")
    import jax

    jax.config.update("jax_platforms", "cpu")
    make_fixture()
