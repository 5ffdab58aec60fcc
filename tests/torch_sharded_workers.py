"""What each rank runs in the sharded parity tests (tests/test_torch_
sharded.py, tests/test_torch_pointshard.py). ``parallel/mesh.py::spawn``
starts the ranks as new processes that import these functions by name, so
this module imports neither JAX nor pytest. Not a test module: pytest
collects nothing here.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_ref  # noqa: E402


class _Patch:
    """``monkeypatch.setattr`` for a whole child process."""

    @staticmethod
    def setattr(obj, name, value):
        setattr(obj, name, value)


def _small_model(net=None):
    """The small TFlow with the committed weights on the CPU (``net``
    overrides ``torch_ref.SMALL_NET``'s fields)."""
    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.weights import load_tflow

    return load_tflow(FlowNetConfig(**{**torch_ref.SMALL_NET, **(net or {})}),
                      device="cpu")


def fail_on_rank(mesh, rank):
    if mesh.rank == rank:
        raise ValueError(f"rank {rank} fails")
    return mesh.rank


def shard(mesh, batch):
    """``shard_batch`` of this rank, as numpy."""
    from ssf_slam_tpu_torch.parallel.mesh import shard_batch

    return {k: v.numpy() for k, v in shard_batch(batch, mesh).items()}


def pointshard(mesh, q, p, f, k, halo, backend):
    """``pointsharded_knn_group`` on this rank: (sqdist, idx, grouped)."""
    from ssf_slam_tpu_torch.parallel.pointshard import pointsharded_knn_group

    d, i, g = pointsharded_knn_group(q, p, f, k, mesh, halo=halo,
                                     backend=backend)
    return d.numpy(), i.numpy(), g.numpy()


def sequences(mesh, seqs, cfg, with_model):
    """``run_sequences_sharded`` of the D sequences: (n states, outputs),
    with the mapping back end's kNN rounded as on XLA's CPU."""
    from ssf_slam_tpu_torch.parallel.mesh import run_sequences_sharded

    torch_ref.round_knn_like_xla_cpu(_Patch())
    model = _small_model() if with_model else None
    states, outs = run_sequences_sharded(seqs, cfg, mesh, model=model)
    return len(states), outs


def streaming(mesh, paths, seqs, cfg, depth, net=None):
    """The fused sharded run of ``seqs`` in batch (on the banded backend
    under the stream's anchored box) and streamed from the stripe over
    ``paths``, and streamed again from this rank's own path alone: (batch
    outputs, streamed outputs, stats, outputs of the own stream)."""
    from ssf_slam_tpu_torch.data.ssfb import SsfbStripe
    from ssf_slam_tpu_torch.parallel.mesh import (
        run_sequences_sharded,
        run_sequences_sharded_streaming,
    )

    from ssf_slam_tpu_torch.parallel.mesh import anchored_box

    torch_ref.round_knn_like_xla_cpu(_Patch())
    model = _small_model(net)
    box = None
    if model.cfg.neighbor_backend == "banded":  # the stream's own box
        box = anchored_box(np.stack([s[0]["pos1"] for s in seqs]), 100.0,
                           "cpu")
    _, batch = run_sequences_sharded(seqs, cfg, mesh, model=model, box=box)
    outs = []
    for stripe_paths in (paths, [paths[mesh.rank]]):
        stripe = SsfbStripe(stripe_paths)
        try:
            _, stream, stats = run_sequences_sharded_streaming(
                stripe.batches(), cfg, mesh, model, pipeline_depth=depth)
        finally:
            stripe.close()
        outs.append((stream, stats))
    return batch, outs[0][0], outs[0][1], outs[1][0]


class Capture:
    """An optimizer that keeps the gradient it is given (in its state) and
    leaves the parameters as they are."""

    def lr(self, count):
        return 0.0

    def update(self, grads, state, params):
        state.grads = {k: g.clone() for k, g in grads.items()}
        state.count += 1


class CaptureState:
    def __init__(self):
        self.count, self.grads = 0, None


def train_step(mesh, batch, lw, capture, net=None):
    """One sharded f32 train step of the small TFlow (``net`` overriding
    its fields) from the committed weights on ``batch`` (the global one;
    this rank takes its shard).

    ``capture``: (loss, flat Flax gradient, flat batch statistics, the
    gradient with the knife-edge activations flipped, their count),
    gradients averaged over the ranks; else, with the port's optax chain
    at TrainConfig's defaults: (loss, flat Flax parameters and batch
    statistics after the step)."""
    import torch.distributed as dist

    from ssf_slam_tpu_torch.config import LossConfig, TrainConfig
    from ssf_slam_tpu_torch.parallel.mesh import (
        make_sharded_train_step,
        shard_batch,
    )
    from ssf_slam_tpu_torch.train.trainer import (
        TrainState,
        create_train_state,
        forward_loss,
    )
    from ssf_slam_tpu_torch.weights import to_flax

    local = shard_batch(batch, mesh)
    model = _small_model(net).train()
    loss_cfg = LossConfig(seg_class_weights=lw)
    tcfg = TrainConfig(batch_size=len(batch["pos1"]))
    if not capture:
        state, tx = create_train_state(model, tcfg)
        step = make_sharded_train_step(model, tx, mesh, tcfg, loss_cfg)
        state, m = step(state, local)
        return float(m["loss"]), to_flax(model)
    state = TrainState(model, CaptureState())
    step = make_sharded_train_step(model, Capture(), mesh, tcfg, loss_cfg)
    state, m = step(state, local)
    grads = to_flax(model, state.opt_state.grads)
    stats = {k: v for k, v in to_flax(model).items()
             if k.startswith("batch_stats/")}
    flipped, n_edge = torch_ref.edge_flipped_gradient(
        _with_group(mesh, net),
        lambda mdl: forward_loss(mdl, local, loss_cfg)[0])
    for g in flipped.values():
        dist.all_reduce(g)
        g /= mesh.world_size
    return float(m["loss"]), grads, stats, to_flax(model, flipped), n_edge


def _with_group(mesh, net=None):
    """The small model in train mode with its BatchNorms on the mesh."""
    from ssf_slam_tpu_torch.models.layers import BatchNorm

    model = _small_model(net).train()
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = mesh.group
    return model
