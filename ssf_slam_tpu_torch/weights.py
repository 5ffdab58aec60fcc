"""Flax -> PyTorch parameters, and the committed weights.

``weights/ssf_r3ft2.npz`` holds the SSF model ``runs/ssf_r3ft2/best`` as
flat float32 leaves keyed by their Flax path
(``params/flow0_r/mlp_q/Dense_0_part0/kernel``,
``batch_stats/sa1/PointMLP_0/BatchNorm_0/mean``, ...): 320 leaves,
2,269,396 values. It was exported from the orbax checkpoint by
``tests/test_torch_weights.py --export``, which also pins it to the
checkpoint; the card's machine has no orbax, so the port reads only the npz.
``to_flax`` goes the other way, for the trainer's npz checkpoints and for
comparing the port's parameters with JAX's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ssf_slam_tpu_torch.config import FlowNetConfig
from ssf_slam_tpu_torch.device import resolve_device
from ssf_slam_tpu_torch.models.layers import BatchNorm

DEFAULT_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "weights", "ssf_r3ft2.npz")

# Flax leaf name -> (torch name, transpose)
_LEAVES = {
    "kernel": ("weight", True),  # Dense [in, out] -> [out, in]
    "bias": ("bias", False),
    "scale": ("weight", False),  # BatchNorm
    "mean": ("running_mean", False),
    "var": ("running_var", False),
}


def load_npz(path: str = DEFAULT_NPZ) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def from_flax(tree: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat Flax variables {"params/a/b/kernel": array, "batch_stats/...":
    array} -> a state dict for ``models.tflow.TFlow``."""
    out = {}
    for key, value in tree.items():
        collection, *path, leaf = key.split("/")
        if collection not in ("params", "batch_stats") or leaf not in _LEAVES:
            raise KeyError(f"unexpected Flax leaf {key}")
        name, transpose = _LEAVES[leaf]
        arr = np.asarray(value, np.float32)
        out[".".join([*path, name])] = torch.from_numpy(
            np.ascontiguousarray(arr.T if transpose else arr))
    return out


def to_flax(model: torch.nn.Module,
            tensors: dict | None = None) -> dict[str, np.ndarray]:
    """The converse of ``from_flax``: a TFlow's parameters and running
    statistics as flat float32 Flax leaves {"params/a/b/kernel": array,
    "batch_stats/a/b/mean": array}, the layout of the committed npz.
    ``tensors`` (by state-dict name, e.g. gradients) replaces the state
    dict."""
    names = {v[0]: k for k, v in _LEAVES.items() if k != "scale"}
    out = {}
    for key, t in (model.state_dict() if tensors is None
                   else tensors).items():
        *path, name = key.split(".")
        owner = model.get_submodule(".".join(path))
        if isinstance(owner, BatchNorm):
            leaf = {"weight": "scale", "bias": "bias", "running_mean": "mean",
                    "running_var": "var"}[name]
        else:
            leaf = names[name]
        collection = "batch_stats" if leaf in ("mean", "var") else "params"
        arr = t.detach().float().cpu().numpy().copy()  # no aliasing
        out["/".join([collection, *path, leaf])] = np.ascontiguousarray(
            arr.T if _LEAVES[leaf][1] else arr)
    return out


def save_npz(path: str, tree: dict[str, np.ndarray]) -> None:
    """Write flat leaves (``to_flax``'s) as an uncompressed npz, through a
    temporary file so that a reader never sees half a file."""
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **tree)
    os.replace(tmp, path)


def load_tflow(cfg: FlowNetConfig, path: str = DEFAULT_NPZ,
               device: str | torch.device = "cuda"):
    """TFlow with the weights of an npz (the committed ones by default, or
    a ``best.npz`` the port's trainer wrote), in eval mode on ``device``.
    The Dense layers keep float32 masters and compute in the config's type
    (BatchNorm in float32, as Flax computes it). With ``fuse_attention``
    the cost volumes' weightnets are folded, from the float32 weights."""
    from ssf_slam_tpu_torch.models.costvolume import AttentiveCostVolume
    from ssf_slam_tpu_torch.models.tflow import TFlow

    dev = resolve_device(device)
    model = TFlow(cfg)
    model.load_state_dict(from_flax(load_npz(path)), strict=True)
    if cfg.fuse_attention:
        for m in model.modules():
            if isinstance(m, AttentiveCostVolume):
                m.fold_weights()
    return model.to(dev).eval()
