"""Inference helpers for the scene-flow net (ssf_slam_tpu/models/inference.py).

``predict_flow_resampled`` is the reference's test-time permutation
resampling (main_sju_occ_ros.py:196-216): the network's FPS starts at
index 0, so permuting the input order gives an ensemble of predictions,
averaged back in the original order. The JAX package draws the
permutations with ``jax.random``; the port draws them from a
``torch.Generator``, or takes them as given (``perms``), which is how the
tests hand both packages the same ensemble. On the banded backend TFlow
Morton-sorts its input, so its members can differ only where the FPS of a
sorted cloud does: the ensemble may be nearly one prediction.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def predict_flow(model, pc1: Tensor, pc2: Tensor) -> Tensor:
    """[B, N, 3] x 2 -> [B, N, 3 (+1)] finest-level flow."""
    flows, _ = model(pc1, pc2)
    return flows[0]


def predict_flow_resampled(model, pc1: Tensor, pc2: Tensor,
                           generator: torch.Generator | None = None,
                           n_resample: int = 10,
                           perms: Tensor | None = None) -> Tensor:
    """The mean over R permutations of pc1 ([R, N] ``perms``, else R =
    ``n_resample`` drawn from ``generator``) of the flow predicted for the
    permuted cloud, each put back into the original order."""
    n = pc1.shape[1]
    if perms is None:
        dev = generator.device if generator is not None else "cpu"
        perms = torch.stack([torch.randperm(n, generator=generator,
                                            device=dev)
                             for _ in range(n_resample)])
    ens = []
    for perm in perms.to(pc1.device).long():
        out = predict_flow(model, pc1[:, perm], pc2)
        ens.append(out[:, torch.argsort(perm)])
    return torch.stack(ens).mean(0)
