"""SLAM state checkpoint and resume (ssf_slam_tpu/engine/checkpoint.py).

The whole carry of the per-scan step (``SlamState``: odometry pose,
velocity, ONLY_PC's local map, the keyframe buffers, the loop factors) is
saved with the index of the next scan, so a crashed run resumes by
replaying from there. The JAX package writes an orbax checkpoint; the port
writes an npz of flat named leaves (``last_feat/xyz``, ``map_state/kf_q``,
..., ``scan_index``), as the card's machine has no orbax.

Payloads from before ``MapState`` grew its round-4 and round-5 fields load
as the JAX package's do: a missing ``n_loops_total`` is ``n_loops``, and
missing ``kf_rnorm`` / ``kf_rvalid`` are zero / invalid (the scan-to-map
refine then treats those keyframes as plane-less, which costs refinement
coverage, never correctness). ``slam_state_from_flax`` converts a JAX
``SlamState`` (as a numpy tree) into the port's.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ssf_slam_tpu_torch.config import PipelineConfig
from ssf_slam_tpu_torch.device import resolve_device
from ssf_slam_tpu_torch.engine.pipeline import SlamState, init_slam_state
from ssf_slam_tpu_torch.mapping.keyframes import MapState

# MapState's host cursors (0-d int32 arrays in the JAX package)
_CURSORS = ("n_kf", "n_loops", "n_loops_total", "loop_record_index")
# the JAX package stores these [K, 3, F] / [K, 3, R] (a TPU lane layout);
# the port [K, F, 3] / [K, R, 3]
_TRANSPOSED = ("kf_cloud", "kf_rnorm")


def _flatten(state: SlamState) -> dict[str, np.ndarray]:
    out = {}
    for name, value in state._asdict().items():
        if isinstance(value, tuple):  # FeatureCloud, PlaneModel, MapState
            for sub, leaf in value._asdict().items():
                out[f"{name}/{sub}"] = _to_numpy(leaf)
        else:
            out[name] = _to_numpy(value)
    return out


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_slam_state(path: str, state: SlamState, scan_index: int) -> None:
    """Write ``state`` and the next scan's index as an npz, through a
    temporary file so that a reader never sees half a checkpoint."""
    flat = _flatten(state)
    flat["scan_index"] = np.asarray(scan_index, np.int64)
    tmp = f"{path}.tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def _backfill(map_leaves: dict, template: MapState) -> dict:
    """The legacy migration: the fields a payload lacks, from the rules of
    the JAX package's ``load_slam_state``."""
    out = dict(map_leaves)
    if "n_loops_total" not in out:
        out["n_loops_total"] = out["n_loops"]
    for key in ("kf_rnorm", "kf_rvalid"):
        if key not in out:
            out[key] = torch.zeros_like(getattr(template, key))
    return out


def _tensor(value, want: torch.Tensor, name: str) -> torch.Tensor:
    """``value`` on ``want``'s device in its type; raises unless the shapes
    agree."""
    t = torch.tensor(np.asarray(value), dtype=want.dtype, device=want.device)
    if t.shape != want.shape:
        raise ValueError(f"checkpoint leaf {name} has shape "
                         f"{tuple(t.shape)}, the config wants "
                         f"{tuple(want.shape)}")
    return t


def _build(leaves: dict, cfg: PipelineConfig, device) -> SlamState:
    """A SlamState from flat numpy leaves in the port's layouts, each held
    to the shape of the template ``init_slam_state(cfg)``."""
    template = init_slam_state(cfg, resolve_device(device))

    def group(name):
        tpl = getattr(template, name)
        sub = {k[len(name) + 1:]: v for k, v in leaves.items()
               if k.startswith(name + "/")}
        if name == "map_state":
            sub = _backfill(sub, tpl)
        return type(tpl)(**{
            k: (int(np.asarray(sub[k])) if k in _CURSORS
                else _tensor(sub[k], getattr(tpl, k), f"{name}/{k}"))
            for k in tpl._fields})

    return SlamState(
        last_feat=group("last_feat"), last_planes=group("last_planes"),
        have_last=bool(np.asarray(leaves["have_last"])),
        **{k: _tensor(leaves[k], getattr(template, k), k)
           for k in ("odom_q", "odom_t", "vel_q", "vel_t")},
        map_state=group("map_state"))


def load_slam_state(path: str, cfg: PipelineConfig,
                    device: str | torch.device = "cuda"
                    ) -> tuple[SlamState, int]:
    """(state, index of the next scan) from ``save_slam_state``'s npz; the
    config gives the buffers' shapes, and a leaf that does not fit them
    raises."""
    with np.load(path) as z:
        leaves = {k: z[k] for k in z.files}
    return _build(leaves, cfg, device), int(leaves["scan_index"])


def slam_state_from_flax(tree, cfg: PipelineConfig,
                         device: str | torch.device = "cuda") -> SlamState:
    """The JAX package's ``SlamState`` as a numpy tree
    (``jax.tree.map(np.asarray, state)``, named tuples kept) -> the
    port's: the keyframe clouds and stored normals transposed to
    [K, F, 3] / [K, R, 3], the cursors and the first-frame gate as host
    values, loop indices as int64."""
    leaves = {}
    for name, value in tree._asdict().items():
        if hasattr(value, "_asdict"):
            for sub, leaf in value._asdict().items():
                leaf = np.asarray(leaf)
                if name == "map_state" and sub in _TRANSPOSED:
                    leaf = np.swapaxes(leaf, -1, -2)
                leaves[f"{name}/{sub}"] = leaf
        else:
            leaves[name] = np.asarray(value)
    return _build(leaves, cfg, device)
