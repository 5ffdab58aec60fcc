"""The committed weights (flat Flax leaves in an npz) as the state dict
of the reference's TFlow."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.plain.config import FlowNetConfig

# Flax leaf name -> (torch name, transpose)
_LEAVES = {
    "kernel": ("weight", True),  # Dense [in, out] -> [out, in]
    "bias": ("bias", False),
    "scale": ("weight", False),  # BatchNorm
    "mean": ("running_mean", False),
    "var": ("running_var", False),
}


def load_npz(path: str) -> dict[str, np.ndarray]:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def from_flax(tree: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """Flat Flax variables {"params/a/b/kernel": array, ...} -> a state
    dict."""
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


def set_quant(model: torch.nn.Module, quant: str | None) -> None:
    """Route every Dense layer of ``model`` through ``quant`` (None: off)."""
    from portbench.reference.plain.models.layers import Dense

    for m in model.modules():
        if isinstance(m, Dense):
            m.quant = quant


def load_tflow(cfg: FlowNetConfig, path: str, device,
               quant: str | None = None):
    """TFlow in float32 with the npz's weights, in eval mode."""
    from portbench.reference.plain.models.tflow import TFlow

    model = TFlow(cfg)
    model.load_state_dict(from_flax(load_npz(path)), strict=True)
    set_quant(model, quant)
    return model.to(device).eval()

