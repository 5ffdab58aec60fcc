"""Training-harness bookkeeping (ssf_slam_tpu/train/harness.py):

- best-checkpoint selection (``parse_best_criterion`` + ``BestTracker``):
  the reference keeps ``model.best.t7`` on the least held-out EPE
  (main_sju_occ_ros.py:439-445); ``gated:<iou>`` also asks for a least
  moving-class IoU;
- chunked-run resume (``save_resume`` / ``load_resume``): parameters,
  batch statistics, the optimizer state and the step in ``last.npz``,
  epoch bookkeeping in ``progress.json``;
- the epoch ``batcher`` (shuffled, drop-last, reseeded per epoch).
"""

from __future__ import annotations

import json
import os
from typing import Callable

import numpy as np
import torch

from ssf_slam_tpu_torch.weights import from_flax, load_npz, save_npz, to_flax


def parse_best_criterion(spec: str) -> float:
    """'epe' -> 0.0 (ungated); 'gated:<iou>' -> the IoU gate; raises
    ValueError on anything else."""
    if spec == "epe":
        return 0.0
    if spec.startswith("gated:"):
        return float(spec.split(":", 1)[1])
    raise ValueError(f"unknown --best-criterion {spec!r}")


class BestTracker:
    """The least EPE among qualifying epochs: ``update(metrics)`` returns
    True when this epoch is the new best; an epoch qualifies when its
    moving-class IoU clears ``gate_iou`` (0: every epoch)."""

    def __init__(self, gate_iou: float = 0.0, best_epe: float = float("inf")):
        self.gate_iou = gate_iou
        self.best_epe = best_epe
        self.best_epoch: int | None = None

    def update(self, metrics: dict, epoch: int | None = None) -> bool:
        qualifies = metrics.get("iou_moving", 0.0) >= self.gate_iou
        if qualifies and metrics["epe3d"] < self.best_epe:
            self.best_epe = float(metrics["epe3d"])
            self.best_epoch = epoch
            return True
        return False

    @property
    def never_qualified(self) -> bool:
        """True when a gate is set and no epoch ever cleared it."""
        return bool(self.gate_iou) and not np.isfinite(self.best_epe)


def save_resume(out_dir: str, state, epoch: int, best_epe: float) -> None:
    """Write ``last.npz`` (the model's Flax leaves, ``opt_state/mu/<name>``
    and ``opt_state/nu/<name>`` by PyTorch parameter name,
    ``opt_state/count`` and ``step``) and progress.json."""
    tree = to_flax(state.model)
    opt = state.opt_state
    for part in ("mu", "nu"):
        for name, t in getattr(opt, part).items():
            tree[f"opt_state/{part}/{name}"] = t.detach().cpu().numpy()
    tree["opt_state/count"] = np.asarray(opt.count, np.int64)
    tree["step"] = np.asarray(state.step, np.int64)
    save_npz(os.path.join(out_dir, "last.npz"), tree)
    with open(os.path.join(out_dir, "progress.json"), "w") as fh:
        json.dump(dict(epoch=epoch, best_epe=best_epe), fh)


def load_resume(out_dir: str, state):
    """Restore (state, start_epoch, best_epe) from ``save_resume``'s files,
    in place. Returns (state, 0, inf) untouched when there is no
    progress.json, so --resume may be passed on a fresh directory."""
    meta_path = os.path.join(out_dir, "progress.json")
    if not os.path.exists(meta_path):
        return state, 0, float("inf")
    with open(meta_path) as fh:
        meta = json.load(fh)
    tree = load_npz(os.path.join(out_dir, "last.npz"))
    model = state.model
    dev = next(model.parameters()).device
    model_tree = {k: v for k, v in tree.items()
                  if k.startswith(("params/", "batch_stats/"))}
    model.load_state_dict({k: v.to(dev) for k, v in
                           from_flax(model_tree).items()}, strict=True)
    opt = state.opt_state
    for part in ("mu", "nu"):
        moments = getattr(opt, part)
        for name in moments:
            moments[name].copy_(torch.from_numpy(
                tree[f"opt_state/{part}/{name}"]))
    opt.count = int(tree["opt_state/count"])
    state.step = int(tree["step"])
    return state, meta["epoch"] + 1, meta["best_epe"]


def batcher(frames: list, batch_size: int, seed_holder: list,
            keys=("pos1", "pos2", "gt", "s_fg_mask", "mask1")) -> Callable:
    """Epoch generator factory: shuffled, drop-last batches of numpy
    arrays; the mutable ``seed_holder`` advances the shuffle seed per epoch
    (and survives resume: the caller seeds it with seed + start_epoch)."""

    def gen():
        rng = np.random.default_rng(seed_holder[0])
        seed_holder[0] += 1
        order = rng.permutation(len(frames))
        for s in range(0, len(order) - batch_size + 1, batch_size):
            items = [frames[int(i)] for i in order[s:s + batch_size]]
            yield {k: np.stack([it[k] for it in items]) for k in keys}

    return gen
