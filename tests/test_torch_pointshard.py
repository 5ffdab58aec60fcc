"""kNN + grouping over a point-sharded cloud (``ssf_slam_tpu_torch/
parallel/pointshard.py``) against the JAX package, on the CPU, at D = 1, 2
and 4 ranks over gloo (``mesh.spawn``) in tests/test_parallel.py::
test_pointsharded_knn_group_recall's case (2048 x 2048 lidar-like points,
k = 8, C = 4, halo 192):

- ``backend="xla"`` live against JAX's ``pointsharded_knn_group`` on
  ``make_mesh(D)`` of the virtual CPU devices: the index sets equal on
  every query whose k-th and (k+1)-th distances are more than 1e-6
  relative apart, the distances within 1e-6 relative, grouped rows equal
  where the indices are;
- ``backend="banded"``: the port's plain versions against JAX's Pallas in
  interpret mode, committed (``pointshard_banded_ref.npz``): indices and
  grouped rows equal, distances within 1e-6 relative (at D = 4 the local
  problem is below ``band_params``' size and both take the exact path);
- for both, recall against ``pointshard_reference`` above 0.9 overall and
  0.85 on every rank's queries, and grouped rows exact copies of the
  Morton-sorted features.

The fixture is made by

    JAX_PLATFORMS=cpu python tests/test_torch_pointshard.py --make-fixture
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

torch.set_num_threads(1)

POINTSHARD_REF = os.path.join(torch_ref.FIXTURE_DIR,
                              "pointshard_banded_ref.npz")
N, M, K, C, HALO = 2048, 2048, 8, 4, 192
WORLDS = (1, 2, 4)
TIE = 1e-6  # relative gap of the k-th and (k+1)-th distances


def _clouds():
    """tests/test_parallel.py's lidar-like clouds: (query, points, feats)."""
    rng = np.random.default_rng(2)
    r = rng.uniform(3, 28, M)
    th = rng.uniform(0, 2 * np.pi, M)
    z = rng.normal(0, 1.5, M)
    pts = np.stack([r * np.cos(th), r * np.sin(th), z], 1).astype(np.float32)
    q = pts[rng.permutation(M)[:N]] + rng.normal(0, 0.05, (N, 3)).astype(
        np.float32)
    feats = rng.normal(size=(M, C)).astype(np.float32)
    return q, pts, feats


def make_fixture(path: str = POINTSHARD_REF) -> None:
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ssf_slam_tpu.parallel.mesh import make_mesh
    from ssf_slam_tpu.parallel.pointshard import pointsharded_knn_group

    q, pts, feats = map(jnp.asarray, _clouds())
    out = {}
    for d in WORLDS:
        with pltpu.force_tpu_interpret_mode():
            res = pointsharded_knn_group(q, pts, feats, K, make_mesh(d),
                                         halo=HALO, backend="banded")
        for name, v in zip(("d", "idx", "grouped"), res):
            out[f"{name}{d}"] = np.asarray(v)
    np.savez_compressed(path, **out)
    print(f"wrote {path}")


def _port(world: int, backend: str, k: int = K):
    """Every rank's result; all ranks must return the same."""
    from ssf_slam_tpu_torch.parallel.mesh import spawn

    results = spawn(workers.pointshard, world, "cpu",
                    (*_clouds(), k, HALO, backend), timeout=120.0)
    for other in results[1:]:
        for a, b in zip(results[0], other):
            np.testing.assert_array_equal(a, b)
    return results[0]


def _check_recall_and_copies(idx, grouped, world: int) -> None:
    """tests/test_parallel.py's recall bounds against the one-device
    oracle, overall and for each rank's Morton rows; grouped rows are the
    Morton-sorted features at the returned indices."""
    from ssf_slam_tpu_torch.ops.neighbors import cloud_box, morton_sort
    from ssf_slam_tpu_torch.parallel.pointshard import pointshard_reference

    q, pts, feats = _clouds()
    _, i_r, _ = pointshard_reference(q, pts, feats, K,
                                     device="cpu")
    i_r = i_r.numpy()
    rows = range(0, N, 4)
    hits = sum(len(set(idx[i]) & set(i_r[i])) for i in rows)
    assert hits / (len(rows) * K) > 0.9
    tq, tp = torch.from_numpy(q)[None], torch.from_numpy(pts)[None]
    box = cloud_box(tq, tp)
    q_perm = morton_sort(tq, box=box)[1][0].numpy()
    s = N // world
    for d in range(world):
        mine = q_perm[d * s:(d + 1) * s:4]
        h = sum(len(set(idx[i]) & set(i_r[i])) for i in mine)
        assert h / (len(mine) * K) > 0.85, f"rank {d}"
    t_perm = morton_sort(tp, box=box)[1][0].numpy()
    np.testing.assert_array_equal(grouped, feats[t_perm][idx])


@pytest.mark.parametrize("world", WORLDS)
def test_pointsharded_xla_matches_jax(world):
    import jax.numpy as jnp

    from ssf_slam_tpu.parallel.mesh import make_mesh
    from ssf_slam_tpu.parallel.pointshard import pointsharded_knn_group

    jd, ji, jg = (np.asarray(v) for v in pointsharded_knn_group(
        *map(jnp.asarray, _clouds()), K, make_mesh(world), halo=HALO,
        backend="xla"))
    d, idx, grouped = _port(world, "xla")
    d_next = _port(world, "xla", K + 1)[0][:, K]
    apart = d_next - d[:, -1] > TIE * np.maximum(d[:, -1], 1e-12)
    assert apart.mean() > 0.99
    for i in np.nonzero(apart)[0]:
        assert set(idx[i]) == set(ji[i]), i
    same = idx == ji
    np.testing.assert_allclose(d, jd, rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(grouped[same], jg[same])
    _check_recall_and_copies(idx, grouped, world)


@pytest.mark.parametrize("world", WORLDS)
def test_pointsharded_banded_matches_jax(world):
    with np.load(POINTSHARD_REF) as z:
        jd, ji, jg = (z[f"{n}{world}"] for n in ("d", "idx", "grouped"))
    d, idx, grouped = _port(world, "banded")
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_array_equal(grouped, jg)
    np.testing.assert_allclose(d, jd, rtol=1e-6, atol=1e-7)
    _check_recall_and_copies(idx, grouped, world)


def test_pointshard_reference_matches_jax():
    import jax.numpy as jnp

    from ssf_slam_tpu.parallel.pointshard import pointshard_reference as jref
    from ssf_slam_tpu_torch.parallel.pointshard import pointshard_reference

    clouds = _clouds()
    jd, ji, jg = (np.asarray(v) for v in jref(*map(jnp.asarray, clouds), K))
    d, idx, grouped = (v.numpy() for v in pointshard_reference(*clouds, K,
                                                             device="cpu"))
    np.testing.assert_array_equal(idx, ji)
    np.testing.assert_array_equal(grouped, jg)
    np.testing.assert_allclose(d, jd, rtol=1e-6, atol=1e-7)


def test_pointsharded_sentinels_keep_the_band_plan_ascending():
    """At world size 1 both flanks wrap: the front halo must sort below
    every code (-1e6) and the back one above (+1e6), or the band plan of
    the extended target is displaced (the JAX chip smoke's recall 0.097)."""
    from ssf_slam_tpu_torch.ops.morton import morton_codes
    from ssf_slam_tpu_torch.ops.neighbors import cloud_box

    q, pts, _ = _clouds()
    tq, tp = torch.from_numpy(q)[None], torch.from_numpy(pts)[None]
    origin, scale = cloud_box(tq, tp)
    ext = torch.cat([torch.full((HALO, 3), -1e6), tp[0],
                     torch.full((HALO, 3), 1e6)])
    codes = morton_codes(ext[None], 64.0, origin[:, None, :],
                         scale[:, None, None])[0]
    assert int(codes[:HALO].max()) <= int(codes[HALO:-HALO].min())
    assert int(codes[-HALO:].min()) >= int(codes[HALO:-HALO].max())


if __name__ == "__main__" and "--make-fixture" in sys.argv:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")
    import jax

    jax.config.update("jax_platforms", "cpu")
    make_fixture()
