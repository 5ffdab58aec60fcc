"""Train the standalone static/moving classifier (the ssfc variant's
``SegNet``), the port's counterpart of scripts/train_segnet.py:

- corpus: the round-3 flow corpus's worlds (slow and crossing movers,
  foreground oversampling), 8192 points a scan, the held-out seed-100
  eval sequence;
- inputs [xyz || flow] with the ground-truth flow plus Gaussian noise of
  sigma ~ U(0, ``--flow-noise``) a step, so that the classifier holds up
  under the deployed predicted flow's error;
- labels 0 = static, 1 = moving; the cross-entropy weighted by the
  inverse-frequency class weights (``compute_label_weights``) over the
  valid points;
- Adam at ``--lr`` (``optax.adam``: no clipping, no decay), the SegNet in
  bf16 on the exact ("xla") neighbour backend, as the JAX script trains
  it; the trained weights serve on the banded kernels
  (``weights.load_segnet(path=...)``);
- each epoch: the eval IoU of both classes and the accuracy at flow noise
  sigma 0.035, ``best.npz`` on each new best mIoU, RunLogger's run.log,
  metrics.jsonl and config.json.

Usage (on the card unless ``--device cpu``):

    python -m ssf_slam_tpu_torch.train.train_segnet --epochs 60 --out runs/seg

The noise draws come from explicit ``torch.Generator``s and cannot equal
JAX's; ``train_step`` and ``eval_metrics`` take the noise as an argument.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

N_POINTS = 8192
EVAL_SIGMA = 0.035  # the deployed predicted flow's EPE scale


def build_corpus(n_worlds: int, frames_per_world: int):
    """The training worlds and the held-out eval sequence (seed 100), as
    scripts/train_segnet.py::build_corpus draws them."""
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    train = []
    for w in range(n_worlds):
        rng = np.random.default_rng(1000 + w)
        slow = w % 3 == 0
        train.extend(generate_sequence(
            n_frames=frames_per_world, n_points=N_POINTS, seed=w,
            noise=float(rng.uniform(0.002, 0.006)),
            n_moving=int(rng.integers(4, 11)),
            radius=float(rng.uniform(18.0, 42.0)),
            mover_speed=(0.5, 3.0) if slow else (3.0, 10.0),
            crossing_frac=0.3, fg_oversample=1024))
    eval_frames = generate_sequence(
        n_frames=16, n_points=N_POINTS, seed=100, noise=0.004, n_moving=5,
        radius=30.0)
    return train, eval_frames


def batches(frames: list, batch_size: int, seed: int, device):
    """Shuffled, drop-last batches {xyz, flow, labels (int64), mask
    (float32)} in the JAX script's order (``default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(frames))
    for s in range(0, len(order) - batch_size + 1, batch_size):
        items = [frames[int(i)] for i in order[s:s + batch_size]]

        def stack(key, dtype):
            return torch.as_tensor(np.stack([it[key] for it in items])
                                   .astype(dtype), device=device)

        yield dict(xyz=stack("pos1", np.float32),
                   flow=stack("gt", np.float32),
                   labels=(stack("s_fg_mask", np.float32) > 0.5).long(),
                   mask=stack("mask1", np.float32))


def flow_noise(shape, max_sigma: float, generator: torch.Generator,
               device) -> torch.Tensor:
    """sigma * N(0, 1) noise with sigma ~ U(0, max_sigma), one sigma a
    batch."""
    sigma = torch.rand((), generator=generator, device=device) * max_sigma
    return sigma * torch.randn(shape, generator=generator, device=device)


def weighted_ce(logits: torch.Tensor, labels: torch.Tensor,
                mask: torch.Tensor, class_w: torch.Tensor) -> torch.Tensor:
    """Cross-entropy over the valid points, each weighted by its class's
    weight: sum(ce w) / max(sum(w), 1), in float32."""
    ll = torch.log_softmax(logits.float(), dim=-1)
    ce = -torch.gather(ll, -1, labels[..., None])[..., 0]
    w = class_w[labels] * mask
    return torch.sum(ce * w) / torch.clamp(torch.sum(w), min=1.0)


def train_step(model, tx, opt_state, batch: dict, noise: torch.Tensor,
               class_w: torch.Tensor) -> torch.Tensor:
    """One update in place, the SegNet in train mode (batch statistics,
    running averages updated) on [xyz || flow + noise]; returns the loss
    (on the device)."""
    model.train()
    params = dict(model.named_parameters())
    logits = model(batch["xyz"], batch["flow"] + noise)
    loss = weighted_ce(logits, batch["labels"], batch["mask"], class_w)
    grads = torch.autograd.grad(loss, list(params.values()))
    tx.update(dict(zip(params, grads)), opt_state, params)
    return loss.detach()


@torch.no_grad()
def eval_metrics(model, batch: dict, noise: torch.Tensor) -> dict:
    """The eval step in eval mode on [xyz || flow + noise]: the IoU of
    the moving and of the static class and the accuracy over the valid
    points (0-d float32 tensors)."""
    model.eval()
    logits = model(batch["xyz"], batch["flow"] + noise)
    pred = torch.argmax(logits.float(), dim=-1)
    m, y = batch["mask"], batch["labels"]
    valid = m > 0

    def iou(p, t):
        inter = torch.sum((p & t) & valid)
        union = torch.sum((p | t) & valid)
        return (inter / torch.clamp(union, min=1)).float()

    return dict(iou_moving=iou(pred == 1, y == 1),
                iou_static=iou(pred == 0, y == 0),
                acc=torch.sum((pred == y) * m) / torch.clamp(torch.sum(m),
                                                             min=1.0))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--n-worlds", type=int, default=8)
    p.add_argument("--frames-per-world", type=int, default=30)
    p.add_argument("--out", default="runs/segnet_torch")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--flow-noise", type=float, default=0.05,
                   help="max sigma of the flow-noise augmentation")
    p.add_argument("--max-seconds", type=float, default=None)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    from ssf_slam_tpu_torch.data.carla import compute_label_weights
    from ssf_slam_tpu_torch.device import resolve_device
    from ssf_slam_tpu_torch.models.layers import init_flax
    from ssf_slam_tpu_torch.models.segnet import SegNet
    from ssf_slam_tpu_torch.train.trainer import Adam
    from ssf_slam_tpu_torch.utils.logging import RunLogger
    from ssf_slam_tpu_torch.weights import save_npz, to_flax

    dev = resolve_device(args.device)
    t_start = time.time()
    print("generating corpus...", flush=True)
    train_frames, eval_frames = build_corpus(args.n_worlds,
                                             args.frames_per_world)
    lw = compute_label_weights(train_frames, max_items=96)
    print(f"corpus: {len(train_frames)} train / {len(eval_frames)} eval; "
          f"label weights {lw} ({time.time() - t_start:.0f}s)", flush=True)

    model = init_flax(SegNet(n_classes=2, dtype="bfloat16"),
                      torch.Generator().manual_seed(0)).to(dev)
    tx = Adam(args.lr)
    opt_state = tx.init(dict(model.named_parameters()))
    class_w = torch.as_tensor(lw, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(7)

    os.makedirs(args.out, exist_ok=True)
    logger = RunLogger(args.out)
    logger.snapshot_config(dict(argv=" ".join(sys.argv), lw=lw.tolist(),
                                n_points=N_POINTS))
    best_miou = -1.0
    for epoch in range(args.epochs):
        t0 = time.time()
        losses = []
        for batch in batches(train_frames, args.batch_size, epoch, dev):
            noise = flow_noise(batch["flow"].shape, args.flow_noise, gen, dev)
            losses.append(train_step(model, tx, opt_state, batch, noise,
                                     class_w))
        # eval at the deployed predicted flow's noise level: one fixed
        # draw, the same for every batch, as the JAX script's PRNGKey(0)
        ms = []
        for batch in batches(eval_frames, args.batch_size, 999, dev):
            eval_gen = torch.Generator(device=dev).manual_seed(0)
            noise = EVAL_SIGMA * torch.randn(batch["flow"].shape,
                                             generator=eval_gen, device=dev)
            ms.append({k: float(v) for k, v in
                       eval_metrics(model, batch, noise).items()})
        agg = {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}
        epoch_loss = (float(torch.stack(losses).mean()) if losses
                      else float("nan"))
        miou = 0.5 * (agg["iou_moving"] + agg["iou_static"])
        dt = time.time() - t0
        logger.cprint(
            f"epoch {epoch}: loss {epoch_loss:.4f} "
            f"iou_mov {agg['iou_moving']:.4f} iou_stat "
            f"{agg['iou_static']:.4f} acc {agg['acc']:.4f} ({dt:.0f}s)")
        logger.metrics(epoch, epoch_loss=epoch_loss, **agg)
        if miou > best_miou:
            best_miou = miou
            save_npz(os.path.join(args.out, "best.npz"), to_flax(model))
        if args.max_seconds and time.time() - t_start > args.max_seconds:
            logger.cprint(f"max-seconds reached at epoch {epoch}")
            break
    logger.cprint(f"best mIoU {best_miou:.4f}")
    logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
