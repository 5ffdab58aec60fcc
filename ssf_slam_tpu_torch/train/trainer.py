"""Scene-flow training loop (ssf_slam_tpu/train/trainer.py).

The reference harness (main_sju_occ_ros.py:324-452): Adam with weight
decay 1e-4, a staircase exponential learning-rate decay counted in
samples with a 1e-5 floor, the multi-scale loss, a per-epoch eval of
EPE / accuracy / outliers and a checkpoint of the best-EPE parameters.

The optimizer is the JAX package's optax chain, written out in
``Optimizer``: clip by global norm 5 (optax's ``g * 5 / |g|`` when
``|g| >= 5``), decayed weights ``g + 1e-4 p`` on every parameter
(BatchNorm's included), Adam (b1 0.9, b2 0.999, eps 1e-8, bias-corrected
moments) and the learning rate of the update count, which starts at 0.

State lives in the model: its parameters are float32 masters that the
train step updates in place, and its BatchNorms update their running
statistics in train mode. Checkpoints are npz files of flat Flax leaves
(``weights.to_flax``), which ``weights.load_tflow`` reads.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ssf_slam_tpu_torch.config import LossConfig, TrainConfig
from ssf_slam_tpu_torch.models.layers import init_flax
from ssf_slam_tpu_torch.models.metrics import flow_metrics, seg_metrics
from ssf_slam_tpu_torch.models.tflow import TFlow, multi_scale_loss
from ssf_slam_tpu_torch.weights import from_flax, load_npz, save_npz, to_flax

Tensor = torch.Tensor


def exp_decay_lr(step: int, cfg: TrainConfig, batch_size: int) -> float:
    """Staircase exponential decay (main_sju_occ_ros.py:396-408); the
    reference counts its global step in SAMPLES."""
    samples = step * batch_size
    return max(cfg.lr * cfg.decay_rate ** (samples // cfg.decay_steps),
               cfg.lr_min)


@dataclasses.dataclass
class AdamState:
    """Adam's moments by parameter name and the update count (Adam's and
    the learning-rate schedule's, which advance together)."""

    count: int
    mu: dict
    nu: dict


class Optimizer:
    """optax.chain(clip_by_global_norm(clip), add_decayed_weights(wd),
    scale_by_adam(b1, b2, eps), scale_by_learning_rate(schedule)) on
    dicts of float32 tensors, updating the parameters in place."""

    def __init__(self, cfg: TrainConfig, batch_size: int, clip: float = 5.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.cfg, self.batch_size = cfg, batch_size
        self.clip, self.b1, self.b2, self.eps = clip, b1, b2, eps

    def init(self, params: dict) -> AdamState:
        zeros = {k: torch.zeros_like(p) for k, p in params.items()}
        return AdamState(0, zeros, {k: z.clone() for k, z in zeros.items()})

    def lr(self, count: int) -> float:
        return exp_decay_lr(count, self.cfg, self.batch_size)

    @torch.no_grad()
    def update(self, grads: dict, state: AdamState, params: dict) -> None:
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        clipped = ~(g_norm < self.clip)  # optax's trigger, NaN included
        count = state.count + 1
        # bias corrections in float32, as optax computes decay ** count
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(count))
        step_size = -self.lr(state.count)
        for name, p in params.items():
            g = torch.where(clipped, (grads[name] / g_norm) * self.clip,
                            grads[name])
            g = g + self.cfg.weight_decay * p
            mu, nu = state.mu[name], state.nu[name]
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * (g * g) + self.b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            p.add_(step_size * u)
        state.count = count


@dataclasses.dataclass
class TrainState:
    """The model (float32 parameters and running statistics), the optimizer
    state and the number of steps taken."""

    model: TFlow
    opt_state: AdamState
    step: int = 0

    @property
    def params(self) -> dict:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> dict:
        return {k: v for k, v in self.model.named_buffers()
                if k.endswith(("running_mean", "running_var"))}


def create_train_state(model: TFlow, cfg: TrainConfig = TrainConfig(),
                       generator: Optional[torch.Generator] = None
                       ) -> tuple[TrainState, Optimizer]:
    """A fresh optimizer over ``model``'s parameters; with ``generator``
    the parameters are first drawn as Flax initialises them."""
    if generator is not None:
        init_flax(model, generator)
    tx = Optimizer(cfg, cfg.batch_size)
    return TrainState(model, tx.init(dict(model.named_parameters()))), tx


def forward_loss(model: TFlow, batch: dict,
                 loss_cfg: LossConfig = LossConfig()) -> tuple[Tensor, list]:
    """The multi-scale loss of a batch {pos1, pos2, gt, mask1, s_fg_mask}
    in the model's current mode: (loss, flows)."""
    flows, fps = model(batch["pos1"], batch["pos2"])
    seg = batch.get("s_fg_mask") if model.cfg.joint_seg else None
    loss = multi_scale_loss(
        flows, batch["gt"], batch["mask1"].float(), fps, alpha=loss_cfg.alpha,
        seg_labels=seg, seg_weight=loss_cfg.seg_weight,
        seg_class_weights=loss_cfg.seg_class_weights)
    return loss, flows


def make_train_step(model: TFlow, tx: Optimizer,
                    cfg: TrainConfig = TrainConfig(),
                    loss_cfg: LossConfig = LossConfig(),
                    freeze_bn: bool = False) -> Callable:
    """``step_fn(state, batch) -> (state, metrics)``: one update in place.
    ``freeze_bn`` runs the forward in eval mode (BatchNorm on its frozen
    running statistics), as the JAX step's ``train=False`` apply does: the
    fine-tuning guard against batch-statistics shift (trainer.py:88-120).
    ``metrics["loss"]`` stays on the device."""
    del cfg  # the schedule lives in ``tx``

    def step_fn(state: TrainState, batch: dict):
        model.train(not freeze_bn)
        params = state.params
        loss, _ = forward_loss(model, batch, loss_cfg)
        grads = torch.autograd.grad(loss, list(params.values()))
        lr = tx.lr(state.opt_state.count)
        tx.update(dict(zip(params, grads)), state.opt_state, params)
        state.step += 1
        return state, dict(loss=loss.detach(), lr=lr)

    return step_fn


def make_eval_step(model: TFlow) -> Callable:
    """``eval_fn(state, batch) -> metrics`` in eval mode: flow metrics of
    the finest flow, and seg metrics of its 4th channel when present."""

    @torch.no_grad()
    def eval_fn(state: TrainState, batch: dict) -> dict:
        model.eval()
        flows, _ = model(batch["pos1"], batch["pos2"])
        mask = batch["mask1"].float()
        pred = flows[0]  # in the compute type, as JAX's metrics take it
        out = flow_metrics(pred[..., :3], batch["gt"], mask)
        if model.cfg.joint_seg and pred.shape[-1] == 4:
            out.update(seg_metrics(pred[..., 3], batch["s_fg_mask"], mask))
        return out

    return eval_fn


def to_device(batch: dict, device) -> dict:
    """numpy batch -> float32 tensors on ``device``."""
    return {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
            for k, v in batch.items()}


def snapshot(state: TrainState) -> dict:
    """The model's parameters and running statistics as flat Flax leaves
    on the host."""
    return to_flax(state.model)


def train_scene_flow(model: TFlow, train_batches: Callable[[], Iterator],
                     eval_batches_fn: Callable[[], Iterator],
                     cfg: TrainConfig = TrainConfig(),
                     loss_cfg: LossConfig = LossConfig(),
                     epochs: Optional[int] = None,
                     ckpt_dir: Optional[str] = None, log_every: int = 100,
                     verbose: bool = True, run_dir: Optional[str] = None,
                     init_state: Optional[TrainState] = None,
                     device="cuda",
                     generator: Optional[torch.Generator] = None
                     ) -> tuple[dict, dict]:
    """A whole run: (the best-EPE snapshot, history).

    ``train_batches`` and ``eval_batches_fn`` return an iterator of numpy
    batch dicts per epoch. ``ckpt_dir`` receives ``best.npz`` at each new
    best EPE; ``run_dir`` a RunLogger's run.log / metrics.jsonl / config.
    Without ``init_state`` the model is initialised from ``generator`` (a
    Flax-style init) when one is given, else kept as it is.
    """
    state, tx = (create_train_state(model, cfg, generator)
                 if init_state is None
                 else (init_state, Optimizer(cfg, cfg.batch_size)))
    step_fn = make_train_step(model, tx, cfg, loss_cfg)
    eval_fn = make_eval_step(model)
    logger = None
    if run_dir is not None:
        from ssf_slam_tpu_torch.utils.logging import RunLogger

        logger = RunLogger(run_dir)
        logger.snapshot_config(dict(train=cfg, loss=loss_cfg, model=model.cfg))
    best_epe, best = float("inf"), snapshot(state)
    history = {"train_loss": [], "eval_epe": []}
    for epoch in range(epochs or cfg.epochs):
        losses = []
        for batch in train_batches():
            state, metrics = step_fn(state, to_device(batch, device))
            losses.append(float(metrics["loss"]))
            if logger is not None and state.step % log_every == 0:
                logger.metrics(state.step, train_loss=losses[-1],
                               lr=metrics["lr"])
        epoch_loss = float(np.mean(losses)) if losses else float("nan")
        epes, mious = [], []
        for batch in eval_batches_fn():
            m = eval_fn(state, to_device(batch, device))
            epes.append(float(m["epe3d"]))
            if "miou" in m:
                mious.append(float(m["miou"]))
        epoch_epe = float(np.mean(epes)) if epes else float("nan")
        history["train_loss"].append(epoch_loss)
        history["eval_epe"].append(epoch_epe)
        msg = f"epoch {epoch}: loss {epoch_loss:.4f} EPE {epoch_epe:.4f}"
        if mious:
            history.setdefault("eval_miou", []).append(float(np.mean(mious)))
            msg += f" mIoU {history['eval_miou'][-1]:.4f}"
        if logger is not None:
            logger.cprint(msg)
            logger.metrics(state.step, epoch=epoch, epoch_loss=epoch_loss,
                           eval_epe=epoch_epe)
        elif verbose:
            print(msg, flush=True)
        if epoch_epe < best_epe:
            best_epe, best = epoch_epe, snapshot(state)
            if ckpt_dir is not None:
                save_checkpoint(ckpt_dir, state)
    if logger is not None:
        logger.close()
    return best, history


def save_checkpoint(path: str, state: TrainState) -> str:
    """Write ``path/best.npz`` (parameters and batch statistics under their
    Flax names) and return its path."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, "best.npz")
    save_npz(out, snapshot(state))
    return out


def load_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load ``path/best.npz`` (or ``path`` itself when it is an npz file)
    into the model; the optimizer state is kept."""
    npz = path if path.endswith(".npz") else os.path.join(path, "best.npz")
    model = state.model
    dev = next(model.parameters()).device
    tree = from_flax(load_npz(npz))
    model.load_state_dict({k: v.to(dev) for k, v in tree.items()},
                          strict=True)
    return state
