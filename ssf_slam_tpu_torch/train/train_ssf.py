"""SSF (joint flow + seg) training on synthetic CARLA-style worlds, the
port's counterpart of scripts/train_ssf.py:

- corpus: worlds of varied seed, traffic density, radius and noise,
  serpentine trajectories, 8192 points per scan, one held-out eval world
  (seed 100);
- inverse-frequency seg label weights on the joint-seg BCE;
- bf16 compute over float32 parameters, the banded CUDA kernels;
- ``best.npz`` on the best eval EPE (``weights.load_tflow`` reads it) and
  a resume file ``last.npz`` (parameters, optimizer state, step), so a run
  can go in wall-clock chunks;
- RunLogger streaming (run.log + metrics.jsonl).

Usage (on the card unless ``--device cpu``):

    python -m ssf_slam_tpu_torch.train.train_ssf --epochs 120 --out runs/t
    python -m ssf_slam_tpu_torch.train.train_ssf ... --resume
    python -m ssf_slam_tpu_torch.train.train_ssf ... --max-seconds 3000

``--init-from`` warm-starts from an npz (a file, or a directory holding
``best.npz``), e.g. the committed ``ssf_slam_tpu_torch/weights/
ssf_r3ft2.npz``, with a fresh optimizer. ``--town02-routes N`` mixes N
routes over the Town02 map (``data/town02.py``, its ``MAP_BIN``; tracked
movers) into the corpus and evaluates a held-out route each epoch
(``t2_*`` metrics); ``--best-on t2|mean`` picks the best checkpoint on
that route, or on the mean EPE of both eval sets gated on the worse
moving-IoU.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ssf_slam_tpu_torch.train.harness import (
    BestTracker,
    batcher,
    load_resume,
    parse_best_criterion,
    save_resume,
)

N_POINTS = 8192


def build_corpus(n_worlds: int, frames_per_world: int, rng_base: int = 0,
                 fg_oversample: int = 0, hard: bool = False,
                 n_points: int = N_POINTS, eval_frames: int = 16):
    """Training worlds plus one held-out eval world (seed 100), exactly as
    scripts/train_ssf.py::build_corpus draws them. ``hard`` gives a third
    of the worlds slow movers and 30 % crossing traffic; ``fg_oversample``
    turns on hybrid foreground sampling of the training frames."""
    from ssf_slam_tpu_torch.data.synthetic import generate_sequence

    train = []
    for w in range(n_worlds):
        rng = np.random.default_rng(1000 + w)
        slow = hard and (w % 3 == 0)
        train.extend(generate_sequence(
            n_frames=frames_per_world, n_points=n_points, seed=rng_base + w,
            noise=float(rng.uniform(0.002, 0.006)),
            n_moving=int(rng.integers(4, 11) if hard
                         else rng.integers(2, 9)),
            radius=float(rng.uniform(18.0, 42.0)),
            mover_speed=(0.5, 3.0) if slow else (3.0, 10.0),
            crossing_frac=0.3 if hard else 0.0,
            fg_oversample=fg_oversample))
    held_out = generate_sequence(n_frames=eval_frames, n_points=n_points,
                                 seed=100, noise=0.004, n_moving=5,
                                 radius=30.0)
    return train, held_out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--epochs", type=int, default=120)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--n-worlds", type=int, default=12)
    p.add_argument("--frames-per-world", type=int, default=40)
    p.add_argument("--out", default="runs/ssf_torch")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--max-seconds", type=float, default=None)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--fg-oversample", type=int, default=0,
                   help="hybrid FG/BG sampling target per training frame")
    p.add_argument("--hard", action="store_true",
                   help="slow/crossing-mover corpus")
    p.add_argument("--town02-routes", type=int, default=0,
                   help="mix N routes over the Town02 map (with tracked "
                        "movers) into the corpus; also evaluates a "
                        "held-out Town02 route each epoch (t2_* metrics)")
    p.add_argument("--town02-frames", type=int, default=24,
                   help="frame pairs per Town02 route")
    p.add_argument("--town02-vehicles", type=int, default=4)
    p.add_argument("--init-from", default=None,
                   help="warm-start parameters and batch statistics from an "
                        "npz, or DIR/best.npz (fresh optimizer)")
    p.add_argument("--best-criterion", default="epe",
                   help="'epe' (least eval EPE) or 'gated:<iou>' (least "
                        "EPE among epochs with moving-IoU >= <iou>)")
    p.add_argument("--seg-weight", type=float, default=1.0,
                   help="scale on the joint-seg BCE term")
    p.add_argument("--best-on", default="eval",
                   choices=("eval", "t2", "mean"),
                   help="which held-out metrics pick the best checkpoint: "
                        "the synthetic eval world ('eval'), the held-out "
                        "Town02 route ('t2', needs --town02-routes), or "
                        "their mean EPE gated on the worse of the two "
                        "moving-IoUs ('mean')")
    p.add_argument("--freeze-bn", action="store_true",
                   help="run BatchNorm on its frozen running statistics")
    p.add_argument("--neighbor-backend", default="banded",
                   help="'banded' (the CUDA kernels) or 'xla' (exact "
                        "selection everywhere)")
    p.add_argument("--device", default="cuda")
    return p, p.parse_args(argv)


def main(argv=None) -> int:
    p, args = parse_args(argv)
    if args.best_on != "eval" and not args.town02_routes:
        p.error(f"--best-on {args.best_on} requires --town02-routes > 0")
    try:
        gate_iou = parse_best_criterion(args.best_criterion)
    except ValueError as exc:
        p.error(str(exc))

    from ssf_slam_tpu_torch.config import (FlowNetConfig, LossConfig,
                                           TrainConfig)
    from ssf_slam_tpu_torch.data.carla import compute_label_weights
    from ssf_slam_tpu_torch.device import resolve_device
    from ssf_slam_tpu_torch.models.layers import init_flax
    from ssf_slam_tpu_torch.models.tflow import TFlow
    from ssf_slam_tpu_torch.ops.precision import set_geom_precision
    from ssf_slam_tpu_torch.train.trainer import (
        create_train_state,
        load_checkpoint,
        make_eval_step,
        make_train_step,
        save_checkpoint,
        to_device,
    )
    from ssf_slam_tpu_torch.utils.logging import RunLogger

    dev = resolve_device(args.device)
    set_geom_precision()
    t_start = time.time()
    print("generating corpus...", flush=True)
    train_frames, eval_frames = build_corpus(
        args.n_worlds, args.frames_per_world,
        fg_oversample=args.fg_oversample, hard=args.hard,
        n_points=N_POINTS)
    t2_eval_frames = []
    if args.town02_routes:
        from ssf_slam_tpu_torch.data.town02 import training_frames

        t2_train = training_frames(
            args.town02_routes, args.town02_frames, n_points=N_POINTS,
            n_vehicles=args.town02_vehicles, seed_base=0,
            fg_oversample=args.fg_oversample)
        # the held-out route: a seed_base whose route and vehicle seeds no
        # training route shares
        t2_eval_frames = training_frames(
            1, 16, n_points=N_POINTS, n_vehicles=args.town02_vehicles,
            seed_base=7777)
        train_frames.extend(t2_train)
        print(f"town02 mix: +{len(t2_train)} train pairs, "
              f"{len(t2_eval_frames)} held-out pairs", flush=True)
    print(f"corpus: {len(train_frames)} train pairs, {len(eval_frames)} eval "
          f"pairs ({time.time() - t_start:.0f}s)", flush=True)
    lw = compute_label_weights(train_frames, max_items=128)
    print(f"label weights (static, moving): {lw}", flush=True)

    net_cfg = FlowNetConfig(npoint=N_POINTS, joint_seg=True,
                            dtype="bfloat16",
                            neighbor_backend=args.neighbor_backend)
    tcfg = TrainConfig(lr=args.lr, batch_size=args.batch_size,
                       epochs=args.epochs)
    loss_cfg = LossConfig(seg_class_weights=(float(lw[0]), float(lw[1])),
                          seg_weight=args.seg_weight)
    model = init_flax(TFlow(net_cfg),
                      torch.Generator().manual_seed(tcfg.seed)).to(dev)
    state, tx = create_train_state(model, tcfg)
    if args.init_from:
        load_checkpoint(os.path.abspath(args.init_from), state)
        print(f"warm-started from {args.init_from}", flush=True)
    step_fn = make_train_step(model, tx, tcfg, loss_cfg,
                              freeze_bn=args.freeze_bn)
    eval_fn = make_eval_step(model)

    os.makedirs(args.out, exist_ok=True)
    start_epoch, best_epe = 0, float("inf")
    if args.resume:
        state, start_epoch, best_epe = load_resume(args.out, state)
        if start_epoch:
            print(f"resumed at epoch {start_epoch} (best EPE "
                  f"{best_epe:.4f})", flush=True)
    logger = RunLogger(args.out)
    logger.snapshot_config(dict(train=tcfg, loss=loss_cfg, model=net_cfg,
                                n_points=N_POINTS,
                                argv=" ".join(sys.argv)))
    train_gen = batcher(train_frames, args.batch_size,
                        [tcfg.seed + start_epoch])
    eval_gen = batcher(eval_frames, args.batch_size, [999])
    t2_gen = (batcher(t2_eval_frames, args.batch_size, [998])
              if t2_eval_frames else None)
    tracker = BestTracker(gate_iou, best_epe)
    for epoch in range(start_epoch, args.epochs):
        t0 = time.time()
        losses = []
        for batch in train_gen():
            state, metrics = step_fn(state, to_device(batch, dev))
            losses.append(metrics["loss"])
        epoch_loss = float(torch.stack(losses).mean()) if losses else float(
            "nan")
        ms = [{k: float(v) for k, v in eval_fn(state, to_device(b, dev))
               .items()} for b in eval_gen()]
        agg = {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}
        if t2_gen is not None:
            t2ms = [{k: float(v) for k, v in eval_fn(state, to_device(b, dev))
                     .items()} for b in t2_gen()]
            agg.update({f"t2_{k}": float(np.mean([m[k] for m in t2ms]))
                        for k in t2ms[0]})
        dt = time.time() - t0
        t2_note = (f" t2EPE {agg['t2_epe3d']:.4f} "
                   f"t2IoUm {agg.get('t2_iou_moving', float('nan')):.4f}"
                   if t2_gen is not None else "")
        logger.cprint(
            f"epoch {epoch}: loss {epoch_loss:.4f} EPE {agg['epe3d']:.4f} "
            f"mIoU {agg.get('miou', float('nan')):.4f} "
            f"acc3dr {agg['acc3d_relax']:.4f}{t2_note} ({dt:.0f}s, "
            f"{len(losses) / dt:.2f} steps/s with eval)")
        logger.metrics(state.step, epoch=epoch, epoch_loss=epoch_loss, **agg)
        if args.best_on == "t2":
            sel = {"epe3d": agg["t2_epe3d"],
                   "iou_moving": agg.get("t2_iou_moving", 0.0)}
        elif args.best_on == "mean":
            sel = {"epe3d": (agg["epe3d"] + agg["t2_epe3d"]) / 2,
                   "iou_moving": min(agg.get("iou_moving", 0.0),
                                     agg.get("t2_iou_moving", 0.0))}
        else:
            sel = agg
        if tracker.update(sel, epoch):
            save_checkpoint(os.path.abspath(args.out), state)
        save_resume(args.out, state, epoch, tracker.best_epe)
        if args.max_seconds and time.time() - t_start > args.max_seconds:
            logger.cprint(f"max-seconds reached at epoch {epoch}; stopping")
            break
    if tracker.never_qualified:
        logger.cprint(f"WARNING: no epoch met the moving-IoU gate {gate_iou}; "
                      f"no best checkpoint written")
    logger.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
