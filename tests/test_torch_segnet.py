"""The port's SegNet (the ssfc classifier) against the JAX package, on the
CPU, and its committed weights against the orbax checkpoint.

- A small SegNet (1024 points, sa_npoints (1024, 256), narrow widths) on
  the banded backend, so that sa1 and fp1 take the banded kNN (1024 x 1024
  meets the work floor 2^20) and sa2 / fp2 the exact path, as at 8192
  points: its logits against a committed JAX run (Pallas in interpret
  mode), within 1e-4; the JAX parameters and batch statistics travel in
  the fixture (``segnet_small_ref.npz``).
- The ``n_sa_levels=0`` per-point MLP branch, live against JAX (no kNN).
- ``ssf_slam_tpu_torch/weights/segnet_r3.npz`` against the orbax
  checkpoint ``runs/segnet_r3/best``, leaf by leaf, and loaded into the
  default SegNet.

The weights and the fixture are made by

    JAX_PLATFORMS=cpu python tests/test_torch_segnet.py --export
    JAX_PLATFORMS=cpu python tests/test_torch_segnet.py --make-fixture
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

SEG_CKPT = os.path.join(torch_ref.REPO, "runs", "segnet_r3", "best")
SEG_NPZ = os.path.join(torch_ref.REPO, "ssf_slam_tpu_torch", "weights",
                       "segnet_r3.npz")
SMALL_REF = os.path.join(torch_ref.FIXTURE_DIR, "segnet_small_ref.npz")
SMALL_SEG = dict(sa_npoints=(1024, 256), sa_nsample=(16, 16),
                 sa_mlps=((16, 16, 32), (32, 32, 64)), head=(32, 16))
MLP_SEG = dict(n_sa_levels=0, head=(32, 32, 16))
N_SMALL = 1024
LOGIT_TOL = 1e-4


def _inputs(n: int = N_SMALL, seed: int = 3):
    """Frame 2's cloud of a generated sequence and its ground-truth flow:
    the classifier's [xyz || flow] input."""
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    f = generate_sequence(n_frames=3, n_points=n, seed=seed, noise=0.004,
                          n_moving=4)[2]
    return (f["pos1"][None].astype(np.float32),
            f["gt"][None].astype(np.float32))


def _jax_variables(seg, xyz, feats, seed: int):
    """Flax init of ``seg`` with batch statistics drawn from a seed (so
    that BatchNorm is not the identity), as a numpy tree."""
    import jax
    import jax.numpy as jnp

    variables = jax.tree.map(np.asarray, seg.init(
        jax.random.PRNGKey(seed), jnp.asarray(xyz), jnp.asarray(feats)))
    rng = np.random.default_rng(seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.normal(0, 0.2, v.shape) if p[-1].key == "mean"
                      else rng.uniform(0.5, 2.0, v.shape)).astype(np.float32),
        variables["batch_stats"])
    return dict(params=variables["params"], batch_stats=stats)


def _port_segnet(flat: dict, **kw):
    from ssf_slam_tpu_torch.models.segnet import SegNet
    from ssf_slam_tpu_torch.weights import from_flax

    model = SegNet(**kw)
    model.load_state_dict(from_flax(flat), strict=True)
    return model.eval()


def make_small_fixture(path: str = SMALL_REF) -> None:
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from ssf_slam_tpu.models.segnet import SegNet as JSegNet

    xyz, feats = _inputs()
    seg = JSegNet(n_classes=2, neighbor_backend="banded", **SMALL_SEG)
    with pltpu.force_tpu_interpret_mode():
        variables = _jax_variables(seg, xyz, feats, seed=1)
        logits = seg.apply(variables, jnp.asarray(xyz), jnp.asarray(feats))
    out = torch_ref.flatten(variables)
    out.update(xyz=xyz, feats=feats, logits=np.asarray(logits))
    np.savez(path, **out)
    print(f"wrote {path}")


def export(path: str = SEG_NPZ) -> None:
    flat = _restore_segnet()
    np.savez(path, **flat)
    n = sum(v.size for v in flat.values())
    print(f"wrote {path}: {len(flat)} leaves, {n} values")


def _restore_segnet() -> dict:
    """The orbax checkpoint as flat Flax leaves (all float32; it restores
    on the CPU without a template)."""
    import orbax.checkpoint as ocp

    restored = ocp.StandardCheckpointer().restore(SEG_CKPT)
    return torch_ref.flatten({k: restored[k]
                              for k in ("params", "batch_stats")})


def test_small_banded_segnet_matches_jax_fixture():
    from ssf_slam_tpu_torch.ops import banded

    with np.load(SMALL_REF) as z:
        ref = {k: z[k] for k in z.files}
    flat = {k: v for k, v in ref.items()
            if k.startswith(("params/", "batch_stats/"))}
    model = _port_segnet(flat, neighbor_backend="banded", **SMALL_SEG)
    xyz, feats = _inputs()
    np.testing.assert_array_equal(xyz, ref["xyz"])
    np.testing.assert_array_equal(feats, ref["feats"])
    banded.reset_launches()
    with torch.inference_mode():
        got = model(torch.from_numpy(xyz), torch.from_numpy(feats)).numpy()
    assert sum(banded.LAUNCHES.values()) == 0  # the plain versions
    assert got.shape == (1, N_SMALL, 2)
    np.testing.assert_allclose(got, ref["logits"], atol=LOGIT_TOL)
    np.testing.assert_array_equal(got.argmax(-1), ref["logits"].argmax(-1))


@pytest.mark.parametrize("backend", ["xla", "banded"])
def test_mlp_branch_matches_jax(backend):
    """``n_sa_levels=0``: the per-point MLP over the features alone (the
    backend is unused there)."""
    import jax.numpy as jnp

    from ssf_slam_tpu.models.segnet import SegNet as JSegNet

    xyz, feats = _inputs(512, seed=4)
    seg = JSegNet(n_classes=2, neighbor_backend=backend, **MLP_SEG)
    variables = _jax_variables(seg, xyz, feats, seed=2)
    want = np.asarray(seg.apply(variables, jnp.asarray(xyz),
                                jnp.asarray(feats)))
    model = _port_segnet(torch_ref.flatten(variables), in_feats=3,
                         neighbor_backend=backend, **MLP_SEG)
    with torch.inference_mode():
        got = model(torch.from_numpy(xyz), torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_segnet_npz_equals_checkpoint():
    from ssf_slam_tpu_torch.weights import load_npz

    restored = _restore_segnet()
    npz = load_npz(SEG_NPZ)
    assert sorted(npz) == sorted(restored)
    for k, v in restored.items():
        assert npz[k].dtype == v.dtype == np.float32, k
        np.testing.assert_array_equal(npz[k], v, err_msg=k)


def test_load_segnet_places_every_leaf():
    from ssf_slam_tpu_torch.weights import load_npz, load_segnet

    npz = load_npz(SEG_NPZ)
    model = load_segnet(SEG_NPZ, dtype="float32", device="cpu")
    n_model = sum(t.numel() for t in model.state_dict().values())
    assert n_model == sum(v.size for v in npz.values())
    np.testing.assert_array_equal(
        model.fp1.PointMLP_0.Dense_0_part1.weight.detach().numpy(),
        npz["params/fp1/PointMLP_0/Dense_0_part1/kernel"].T)
    np.testing.assert_array_equal(
        model.stem.BatchNorm_0.running_mean.numpy(),
        npz["batch_stats/stem/BatchNorm_0/mean"])
    assert model.Dense_0.dtype == torch.float32
    assert load_segnet(SEG_NPZ, device="cpu").Dense_0.dtype == torch.bfloat16


if __name__ == "__main__":
    if sys.argv[1:] not in (["--export"], ["--make-fixture"]):
        sys.exit("usage: python tests/test_torch_segnet.py "
                 "--export | --make-fixture")
    import jax

    jax.config.update("jax_platforms", "cpu")
    if sys.argv[1] == "--export":
        export()
    else:
        make_small_fixture()
