"""JAX-side helpers shared by the torch port's parity tests.

Everything here runs the JAX package (the reference) on the CPU and hands
numpy arrays to the tests, which feed the same arrays to
``ssf_slam_tpu_torch``, or makes the port round as the JAX package does on
the CPU. Not a test module: pytest collects nothing here.
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:  # run as a script: python tests/<file>.py
    sys.path.insert(0, REPO)
CKPT = os.path.join(REPO, "runs", "ssf_r3ft2", "best")
WEIGHTS_NPZ = os.path.join(REPO, "ssf_slam_tpu_torch", "weights",
                           "ssf_r3ft2.npz")
FIXTURE_DIR = os.path.join(REPO, "tests", "fixtures", "torch_port")
FUSED_REF = os.path.join(FIXTURE_DIR, "ssf_fused_ref.npz")

# the small TFlow the CPU parity tests run: the level-0 cost volume and
# warping meet band_params at 1024 * 1024 = 2^20, so the banded kernels fire
SMALL_NET = dict(npoint=1024, sa_npoints=(512, 256, 128, 64),
                 joint_seg=True, neighbor_backend="banded")


def flatten(tree, prefix: str = "") -> dict:
    """Nested dict of arrays -> {"a/b/c": np.ndarray}."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flatten(v, key))
        else:
            out[key] = np.asarray(v)
    return out


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def restore_checkpoint(path: str = CKPT) -> dict:
    """Orbax restore of a TFlow checkpoint onto the CPU.

    The checkpoint's sharding names a TPU, so a restore without a target
    fails on a CPU host; the target built from ``jax.eval_shape`` of the
    model init re-homes every leaf on CPU device 0. Parameter shapes do not
    depend on the point count, so any joint-seg config gives the target.
    """
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    from ssf_slam_tpu.config import FlowNetConfig
    from ssf_slam_tpu.models import TFlow

    model = TFlow(cfg=FlowNetConfig(**SMALL_NET))
    pc = jnp.zeros((1, SMALL_NET["npoint"], 3))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), pc, pc)
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    target = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=cpu),
        dict(params=shapes["params"], batch_stats=shapes["batch_stats"]))
    restored = ocp.StandardCheckpointer().restore(path, target)
    return jax.tree.map(np.asarray, restored)


def load_npz_variables(path: str = WEIGHTS_NPZ) -> dict:
    """The committed npz as a Flax variables dict (numpy leaves)."""
    with np.load(path) as z:
        return unflatten({k: z[k] for k in z.files})


def xla_cpu_sqdist(x, y):
    """``ssf_slam_tpu_torch.ops.knn.pairwise_sqdist`` rounded as XLA's CPU
    compiler rounds the JAX package's jitted kNN: every xyz dot (the
    squares and the cross term) is fma(z, z', fma(y, y', x * x')). Each
    float32 product is exact in float64, so only the sums round (then once
    more to float32). The mapping back end thresholds and orders the
    expansion distances of ``knn(rerank=False)`` as they are, so its parity
    tests need the reference's rounding; the port itself takes the plain
    float32 expansion on every device."""
    import torch

    def dot3(a, b):
        ad, bd = a.double(), b.double()
        c = (a[..., 0] * b[..., 0]).double()
        c = (ad[..., 1] * bd[..., 1] + c).float().double()
        return (ad[..., 2] * bd[..., 2] + c).float()

    x2, y2 = dot3(x, x)[..., :, None], dot3(y, y)[..., None, :]
    cross = dot3(x[..., :, None, :], y[..., None, :, :])
    return torch.clamp(x2 - 2.0 * cross + y2, min=0.0)


def round_knn_like_xla_cpu(monkeypatch) -> None:
    """Make the port's ``knn(rerank=False)`` distances round as
    ``xla_cpu_sqdist`` for one test (pytest's ``monkeypatch`` undoes it).
    A re-ranked search keeps the plain expansion: its exact re-rank makes
    the candidate pass's rounding irrelevant, and the emulation costs some
    ten times the plain expansion on the CPU."""
    from ssf_slam_tpu_torch.ops import knn

    plain_chunk, plain_sqdist = knn._knn_chunk, knn.pairwise_sqdist

    def chunk(query, points, k, points_mask, slack, rerank):
        if rerank:
            return plain_chunk(query, points, k, points_mask, slack, rerank)
        knn.pairwise_sqdist = xla_cpu_sqdist
        try:
            return plain_chunk(query, points, k, points_mask, slack, rerank)
        finally:
            knn.pairwise_sqdist = plain_sqdist

    monkeypatch.setattr(knn, "_knn_chunk", chunk)
