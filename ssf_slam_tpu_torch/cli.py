"""Command line of the port (ssf_slam_tpu/cli.py), the launch-file
equivalent:

    python -m ssf_slam_tpu_torch.cli run --variant onlypc --synthetic --out traj.tum
    python -m ssf_slam_tpu_torch.cli run --variant ssf --dataset /data/SF/04 \\
        --ckpt ssf_slam_tpu_torch/weights/ssf_r3ft2.npz --out traj.tum
    python -m ssf_slam_tpu_torch.cli run --variant ssf --synthetic --stream \\
        --ckpt ssf_slam_tpu_torch/weights/ssf_r3ft2.npz
    python -m ssf_slam_tpu_torch.cli evaluate --synthetic --seed 100 --frames 40 \\
        --ckpt ssf_slam_tpu_torch/weights/ssf_r3ft2.npz \\
        --seg-ckpt ssf_slam_tpu_torch/weights/segnet_r3.npz \\
        --variants onlypc,noseg,sf,ssf,ssfc
    python -m ssf_slam_tpu_torch.cli train --synthetic --epochs 5 --ckpt-dir runs
    python -m ssf_slam_tpu_torch.cli eval-flow --synthetic --ckpt runs/best.npz

The subcommands and flags are the JAX package's; ``--ckpt`` and
``--seg-ckpt`` take the port's npz files (flat Flax leaves, e.g. the
committed ``weights/*.npz`` or a trainer's ``best.npz``, or a directory
holding ``best.npz``). One flag is added: ``--device`` (default ``cuda``);
nothing falls back to the CPU when CUDA is absent, it raises. Variant names
mirror the launch files: onlypc, seg, noseg, sf, ssf (the joint head), ssfc
(the separate SegNet classifier, ``--seg-ckpt``).

``run --profile DIR`` (and ``run --stream --profile DIR``) runs under
``torch.profiler`` and writes ``DIR/trace.json``, a Chrome/Perfetto trace
(chrome://tracing, ui.perfetto.dev) of the host and, on CUDA, the card: the
port's ranges ``ssf.step`` (a scan), ``ssf.tower``, ``ssf.head``,
``ssf.slam_step`` with its stages ``ssf.features``, ``ssf.ego_motion``,
``ssf.seg_gate``, ``ssf.mapping``, ``ssf.keyframe`` and ``ssf.loop``, and in
``--stream`` mode ``ssf.readback`` and ``ssf.retire``, over the kernels and
copies each launched. The profiler slows the host, so time a run without
it. ``run --stream`` prints the rate, the completion latency, the dispatch
time (the step's call and its readback enqueued), the held time (a
finished pose waiting in the FIFO behind the dispatch of a scan that was
already waiting, at depth > 1, where its copy was not yet done) and how
many poses were retired early (at once: no scan was waiting, or the copy
was done).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np
import torch


def _load_frames(args) -> list:
    if args.synthetic:
        from ssf_slam_tpu_torch.data.synthetic import generate_sequence

        return generate_sequence(
            n_frames=args.frames, n_points=args.n_points, seed=args.seed,
            noise=0.004, n_moving=args.n_moving,
            trajectory=args.trajectory,
        )
    if args.dataset.endswith(".ssfb"):
        # native mmap + prefetch loader (native/loader.cc)
        from ssf_slam_tpu_torch.data.ssfb import SsfbSequence

        seq = SsfbSequence(args.dataset)
        return [fr for _, fr in seq.prefetch_iter()]
    from ssf_slam_tpu_torch.data.generic import make_dataset

    # --dataset-kind selects the reader dialect (the reference's
    # --dataset/--dataset_cls switch, main_sju_occ_ros.py:613-666)
    ds = make_dataset(args.dataset_kind or "carla", args.dataset,
                      n_points=args.n_points)
    return [ds[i] for i in range(len(ds))]


def _npz_path(path: str) -> str:
    """A checkpoint argument: an npz file, or a directory with best.npz."""
    return path if path.endswith(".npz") else os.path.join(path, "best.npz")


def _build_model(args, variant: str | None = None,
                 joint: bool | None = None):
    """TFlow (+ the ``--ckpt`` weights) for the sf / ssf / ssfc variants,
    in eval mode on ``--device``.

    A joint flow+seg checkpoint (4-channel head) serves the sf variant too:
    the stored shapes are compared with the 3-channel model's, and on a
    head mismatch the joint model is built instead, its seg channel unused.
    """
    from ssf_slam_tpu_torch.config import FlowNetConfig
    from ssf_slam_tpu_torch.models.layers import init_flax
    from ssf_slam_tpu_torch.models.tflow import TFlow
    from ssf_slam_tpu_torch.weights import from_flax, load_npz

    dev = torch.device(args.device)
    if joint is None:
        joint = (variant or args.variant) == "ssf"
    restored = from_flax(load_npz(_npz_path(args.ckpt))) if args.ckpt \
        else None

    def build(jt: bool):
        return TFlow(FlowNetConfig(npoint=args.n_points, joint_seg=jt,
                                   dtype=args.net_dtype,
                                   neighbor_backend=args.neighbor_backend))

    def mismatches(model):
        tmpl = model.state_dict()
        if set(tmpl) != set(restored):
            return [("<structure>", "<structure>")]
        return [(tuple(tmpl[k].shape), tuple(v.shape))
                for k, v in restored.items() if tmpl[k].shape != v.shape]

    model = build(joint)
    if restored is not None:
        bad = mismatches(model)
        if bad and not joint:  # flow-only model vs a joint checkpoint
            model = build(True)
            bad = mismatches(model)
        if bad:
            raise ValueError(
                f"checkpoint {args.ckpt} does not fit the model "
                f"(npoint={args.n_points}): first mismatch "
                f"template{bad[0][0]} vs stored{bad[0][1]} — checkpoints "
                "bind --n-points and the head shape")
        model.load_state_dict(restored, strict=True)
    else:
        print("WARNING: no --ckpt given; flow net runs with random weights",
              file=sys.stderr)
        init_flax(model, torch.Generator().manual_seed(0))
    return model.to(dev).eval()


def _predict_flow(frames: list, args, variant: str | None = None) -> None:
    """TFlow over each frame pair, writing ``pred_flow`` (and the joint
    head's ``static_mask``) into the frames. With ``--resample N`` each
    pair is predicted N times under random point permutations and averaged
    (main_sju_occ_ros.py:196-216)."""
    from ssf_slam_tpu_torch.models.inference import (
        predict_flow,
        predict_flow_resampled,
    )

    model = _build_model(args, variant)
    joint = model.cfg.joint_seg and (variant or args.variant) == "ssf"
    dev = torch.device(args.device)
    gen = torch.Generator().manual_seed(args.seed)
    with torch.inference_mode():
        for f in frames:
            pc1 = torch.as_tensor(np.asarray(f["pos1"], np.float32),
                                  device=dev)[None]
            pc2 = torch.as_tensor(np.asarray(f["pos2"], np.float32),
                                  device=dev)[None]
            if args.resample > 1:
                out = predict_flow_resampled(model, pc1, pc2, gen,
                                             n_resample=args.resample)
            else:
                out = predict_flow(model, pc1, pc2)
            out = out[0].float().cpu().numpy()
            f["pred_flow"] = out[:, :3]
            if joint:
                f["static_mask"] = out[:, 3] < 0.0  # logit < 0: static


def _build_seg_classifier(args):
    """The SegNet classifier (+ ``--seg-ckpt``) as ``seg_apply``: built as
    the JAX CLI builds it (2 classes, bf16, ``--neighbor-backend``)."""
    from ssf_slam_tpu_torch.models.layers import init_flax
    from ssf_slam_tpu_torch.models.segnet import SegNet
    from ssf_slam_tpu_torch.weights import load_segnet

    if args.seg_ckpt:
        return load_segnet(_npz_path(args.seg_ckpt), dtype="bfloat16",
                           device=args.device,
                           neighbor_backend=args.neighbor_backend)
    print("WARNING: no --seg-ckpt given; classifier runs with random "
          "weights", file=sys.stderr)
    model = SegNet(n_classes=2, dtype="bfloat16",
                   neighbor_backend=args.neighbor_backend)
    init_flax(model, torch.Generator().manual_seed(0))
    return model.to(torch.device(args.device)).eval()


def _pipeline_cfg(variant, args, force_raw: bool = False):
    from ssf_slam_tpu_torch.config import PipelineConfig

    cfg = PipelineConfig(variant=variant)
    if args.geom_refine and not force_raw:
        cfg = cfg.replace(
            egomotion=dataclasses.replace(cfg.egomotion, geom_refine=True))
    return cfg


def _run_variant(frames: list, variant_name: str, args, *,
                 force_raw: bool = False):
    """One pipeline variant over the frames -> (times, pos, quat, state).

    sf / ssf / ssfc run the fused step (TFlow, and for ssfc the SegNet,
    inside the per-scan step); the others run the SLAM step on the
    frames' ground-truth flow. ``force_raw`` ignores --geom-refine:
    ``cmd_evaluate`` pins the seg reference run raw, as the JAX CLI does
    (refine anchored on the GT mask degrades seg, 0.0354 -> 0.0999 m ATE
    vs GT in the JAX package's round-5 run, and a degraded reference
    distorts every other column).
    """
    from ssf_slam_tpu_torch.config import Variant
    from ssf_slam_tpu_torch.engine.pipeline import run_sequence

    classifier = variant_name == "ssfc"
    variant = Variant.SSF if classifier else Variant(variant_name)
    cfg = _pipeline_cfg(variant, args, force_raw)
    if variant in (Variant.SF, Variant.SSF):
        if args.resample > 1 and not classifier:
            # the ensemble is predicted per pair on the host
            frames = [dict(f) for f in frames]
            _predict_flow(frames, args, variant_name)
            state, outs = run_sequence(frames, cfg, flow_key="pred_flow",
                                       device=args.device)
        else:
            from ssf_slam_tpu_torch.engine.fused import run_sequence_fused

            # ssfc runs the same flow net as ssf (a joint checkpoint's
            # fourth channel unused); only the mask's source differs
            model = _build_model(args, "ssf" if classifier else variant_name)
            seg_apply = _build_seg_classifier(args) if classifier else None
            state, outs = run_sequence_fused(
                model, frames, cfg, device=args.device,
                use_gmm=variant == Variant.SF, seg_apply=seg_apply,
                return_state=True)
    else:
        state, outs = run_sequence(frames, cfg, device=args.device)
    _report_map(variant_name, state, outs)
    times = np.asarray([f["time"] for f in frames])
    return times, outs["pose_t"], outs["pose_q"], state


def _report_map(variant_name: str, state, outs: dict) -> None:
    ms = state.map_state
    n_loops = int(ms.n_loops_total)
    if n_loops:
        print(f"[{variant_name}] loop closures fired: {n_loops}",
              file=sys.stderr)
    cap = int(ms.loop_w.shape[0])
    if n_loops > cap:
        print(f"[{variant_name}] loop buffer saturated: {n_loops} closures "
              f"accepted into {cap} slots (weakest factors evicted; raise "
              "mapping.MAX_LOOPS for very loopy deployments)",
              file=sys.stderr)
    dyn_over = np.asarray(outs.get("n_dyn_over", np.zeros(1, np.int32)))
    if int(dyn_over.max(initial=0)) > 0:
        print(f"[{variant_name}] keyframe seg-gate mover budget exceeded on "
              f"{int((dyn_over > 0).sum())} scans (worst overflow "
              f"{int(dyn_over.max())} points past the 1024-point budget; "
              "gate coverage was reduced on those scans)",
              file=sys.stderr)


def cmd_run(args) -> int:
    from ssf_slam_tpu_torch.engine.evaluation import ate_rmse, rpe, write_tum

    from ssf_slam_tpu_torch.utils.logging import profile_trace

    if args.stream:
        return _cmd_run_stream(args)
    frames = _load_frames(args)
    with profile_trace(args.profile):
        times, pos, quat, state = _run_variant(frames, args.variant, args)
    write_tum(args.out, times, pos, quat)
    print(f"wrote {len(times)} poses to {args.out}")
    if args.map_ply:
        from ssf_slam_tpu_torch.utils.viz import map_to_ply

        n = map_to_ply(state.map_state, args.map_ply)
        print(f"wrote {n} map points to {args.map_ply}")
    if args.synthetic:
        true_pos = np.stack([f["pose1"][1] for f in frames])
        true_rot = np.stack([f["pose1"][0] for f in frames])
        r = rpe(pos, quat, true_pos, true_rot)
        print(f"ATE RMSE vs ground truth: {ate_rmse(pos, true_pos):.4f} m")
        print(f"RPE vs ground truth: {r['trans_rmse']:.4f} m, "
              f"{r['rot_rmse_deg']:.4f} deg")
    return 0


def _cmd_run_stream(args) -> int:
    """Online mode: the fused step per arriving scan, the TUM file written
    as poses retire, the rate and latencies printed (the reference's live
    10 Hz operation, PointCloudOdometry.py:42)."""
    from ssf_slam_tpu_torch.config import Variant
    from ssf_slam_tpu_torch.engine.streaming import StreamingRunner
    from ssf_slam_tpu_torch.utils.logging import profile_trace

    if args.variant not in ("sf", "ssf", "ssfc"):
        print("--stream drives the fused network-in-the-loop variants "
              "(sf/ssf/ssfc)", file=sys.stderr)
        return 2
    classifier = args.variant == "ssfc"
    model = _build_model(args, "ssf" if classifier else args.variant)
    seg_apply = _build_seg_classifier(args) if classifier else None
    cfg = _pipeline_cfg(Variant.SSF, args)
    if args.dataset and args.dataset.endswith(".ssfb"):
        # frames stream straight off the native loader's mmap
        from ssf_slam_tpu_torch.data.ssfb import SsfbSequence

        seq = SsfbSequence(args.dataset)
        frames = (fr for _, fr in seq.prefetch_iter())
    else:
        frames = iter(_load_frames(args))
    runner = StreamingRunner(
        model, cfg, use_gmm=args.variant == "sf", seg_apply=seg_apply,
        tum_path=args.out, pipeline_depth=args.pipeline_depth,
        device=args.device)
    with profile_trace(args.profile):
        stats = runner.run(frames)
    print(f"streamed {stats['n_scans']} scans -> {args.out}")
    if args.map_ply:
        from ssf_slam_tpu_torch.utils.viz import map_to_ply

        n = map_to_ply(runner.final_state.map_state, args.map_ply)
        print(f"wrote {n} map points to {args.map_ply}")
    print(f"rate {stats['hz']:.1f} Hz  completion latency mean "
          f"{stats['latency_ms_mean']:.1f} ms  p95 "
          f"{stats['latency_ms_p95']:.1f} ms  dispatch mean "
          f"{stats['dispatch_ms_mean']:.1f} ms  held mean "
          f"{stats['held_ms_mean']:.1f} ms  retired early "
          f"{stats['retired_early']}  depth "
          f"{stats['pipeline_depth']}  loops {stats['n_loops']}")
    target = 10.0
    print(f"10 Hz live target: {'MET' if stats['hz'] >= target else 'MISSED'}")
    return 0


def cmd_evaluate(args) -> int:
    """The reference's evo protocol (README.md:64-72): the variants on ONE
    sequence, TUM + KITTI trajectories, every variant scored against the
    seg run (evo's --ref) and, with --synthetic, the ground truth."""
    from ssf_slam_tpu_torch.engine.evaluation import ate_rmse, rpe, write_tum
    from ssf_slam_tpu_torch.utils.poses import tum_file_to_kitti

    variants = args.variants.split(",")
    if "seg" not in variants:
        variants = ["seg"] + variants  # the reference trajectory
    frames = _load_frames(args)
    os.makedirs(args.out_dir, exist_ok=True)
    results = {}
    for v in variants:
        times, pos, quat, _ = _run_variant(frames, v, args,
                                           force_raw=(v == "seg"))
        tum = os.path.join(args.out_dir, f"00_{v.upper()}.tum")
        write_tum(tum, times, pos, quat)
        tum_file_to_kitti(tum, tum.replace(".tum", ".kitti"))
        results[v] = (pos, quat)
        print(f"[{v}] wrote {tum}", file=sys.stderr)

    ref_pos, ref_quat = results["seg"]
    have_gt = args.synthetic and "pose1" in frames[0]
    if have_gt:
        gt_pos = np.stack([f["pose1"][1] for f in frames])
    hdr = "| variant | ATE vs Seg (m) | RPE trans (m) | RPE rot (deg) |"
    if have_gt:
        hdr += " ATE vs GT (m) |"
    print(hdr)
    print("|" + "---|" * (hdr.count("|") - 1))
    for v in variants:
        pos, quat = results[v]
        if v == "seg":
            row = f"| {v} | (reference) | | |"
        else:
            r = rpe(pos, quat, ref_pos, ref_quat)
            row = (f"| {v} | {ate_rmse(pos, ref_pos):.4f} "
                   f"| {r['trans_rmse']:.4f} | {r['rot_rmse_deg']:.4f} |")
        if have_gt:
            row += f" {ate_rmse(pos, gt_pos):.4f} |"
        print(row)
    return 0


def cmd_train(args) -> int:
    """TFlow on the frames (80 % train, 20 % eval) through the port's
    ``train_scene_flow``; ``--ckpt-dir`` receives ``best.npz``."""
    from ssf_slam_tpu_torch.config import FlowNetConfig, TrainConfig
    from ssf_slam_tpu_torch.models.tflow import TFlow
    from ssf_slam_tpu_torch.train.trainer import train_scene_flow

    dev = torch.device(args.device)
    frames = _load_frames(args)
    split = max(1, int(0.8 * len(frames)))
    train_frames, eval_frames = frames[:split], frames[split:]

    def to_batches(frs):
        def gen():
            rng = np.random.default_rng(0)
            order = rng.permutation(len(frs))
            for s in range(0, len(order) - args.batch_size + 1,
                           args.batch_size):
                items = [frs[int(i)] for i in order[s:s + args.batch_size]]
                yield {k: np.stack([it[k] for it in items])
                       for k in ("pos1", "pos2", "gt", "s_fg_mask", "mask1")}
        return gen

    model = TFlow(FlowNetConfig(npoint=args.n_points,
                                joint_seg=args.variant == "ssf")).to(dev)
    tcfg = TrainConfig(batch_size=args.batch_size, epochs=args.epochs)
    _, history = train_scene_flow(
        model, to_batches(train_frames), to_batches(eval_frames), cfg=tcfg,
        epochs=args.epochs, ckpt_dir=args.ckpt_dir, device=dev,
        generator=torch.Generator().manual_seed(0))
    print("final eval EPE:", history["eval_epe"][-1])
    return 0


def cmd_eval_flow(args) -> int:
    from ssf_slam_tpu_torch.models.metrics import flow_metrics

    frames = _load_frames(args)
    _predict_flow(frames, args)
    ms = []
    for f in frames:
        m = flow_metrics(
            torch.as_tensor(f["pred_flow"])[None],
            torch.as_tensor(np.asarray(f["gt"], np.float32))[None],
            torch.as_tensor(f["mask1"].astype(np.float32))[None])
        ms.append({k: float(v) for k, v in m.items()})
    agg = {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}
    print("EPE3D {epe3d:.4f}  Acc3DS {acc3d_strict:.4f}  "
          "Acc3DR {acc3d_relax:.4f}  Outlier {outlier:.4f}".format(**agg))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ssf_slam_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--dataset", default=None)
        sp.add_argument("--dataset-kind", default="carla",
                        choices=["carla", "ft3d_hpl", "kitti_hpl",
                                 "ft3d_fn3d", "kitti_fn3d"],
                        help="reader dialect for --dataset (the reference's "
                             "--dataset/--dataset_cls switch)")
        sp.add_argument("--synthetic", action="store_true")
        sp.add_argument("--frames", type=int, default=40)
        sp.add_argument("--n-points", type=int, default=8192)
        sp.add_argument("--n-moving", type=int, default=4)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--trajectory", default="street",
                        choices=["street", "loop"],
                        help="synthetic ego path; 'loop' revisits (exercises "
                             "loop closure)")
        sp.add_argument("--ckpt", default=None,
                        help="TFlow weights: an npz of flat Flax leaves, or "
                             "a directory with best.npz")
        sp.add_argument("--seg-ckpt", default=None,
                        help="SegNet classifier weights (npz) for the ssfc "
                             "variant (run_Pointnet2Seg launch parity)")
        sp.add_argument("--resample", type=int, default=1,
                        help="test-time permutation-ensemble size "
                             "(main_sju_occ_ros.py:196-216)")
        sp.add_argument("--net-dtype", default="bfloat16",
                        choices=["float32", "bfloat16"])
        sp.add_argument("--neighbor-backend", default="banded",
                        choices=["banded", "xla"])
        sp.add_argument(
            "--variant", default="seg",
            choices=["onlypc", "seg", "noseg", "sf", "ssf", "ssfc"],
        )
        sp.add_argument(
            "--geom-refine", action="store_true",
            help="seg-gated point-to-plane refinement of the flow pose on "
                 "the learned-flow variants (odometry/flow_refine.py)")
        sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="where the port runs (no fall back to the CPU "
                             "when CUDA is absent)")

    sp = sub.add_parser("run", help="run a SLAM pipeline, write TUM trajectory")
    common(sp)
    sp.add_argument("--out", default="trajectory.tum")
    sp.add_argument("--map-ply", default=None,
                    help="export the aggregated keyframe map + trajectory "
                         "as a colored PLY (vis_map.py counterpart)")
    sp.add_argument("--stream", action="store_true",
                    help="online mode: per-arriving-scan step + incremental "
                         "TUM + Hz/latency report (live 10 Hz parity)")
    sp.add_argument("--pipeline-depth", type=int, default=2,
                    help="most scans in flight in --stream mode; a pose "
                         "is held only while a scan waits and its copy is "
                         "not done (1 = strictly synchronous)")
    sp.add_argument("--profile", default=None, metavar="DIR",
                    help="run under torch.profiler and write DIR/trace.json "
                         "(Chrome/Perfetto) with the port's ssf.* ranges")
    sp.set_defaults(fn=cmd_run)

    sp = sub.add_parser("train", help="train the scene-flow net")
    common(sp)
    sp.add_argument("--epochs", type=int, default=10)
    sp.add_argument("--batch-size", type=int, default=4)
    sp.add_argument("--ckpt-dir", default=None)
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("eval-flow", help="scene-flow EPE metrics")
    common(sp)
    sp.set_defaults(fn=cmd_eval_flow)

    sp = sub.add_parser(
        "evaluate",
        help="evo protocol: run variants on one sequence, write TUM+KITTI "
             "trajectories, score against the Seg reference run",
    )
    common(sp)
    sp.add_argument("--variants", default="onlypc,noseg,sf,ssf",
                    help="comma-separated; seg is always added as reference")
    sp.add_argument("--out-dir", default="results")
    sp.set_defaults(fn=cmd_evaluate)

    args = p.parse_args(argv)
    if not args.synthetic and args.dataset is None:
        p.error("need --dataset or --synthetic")
    from ssf_slam_tpu_torch.device import resolve_device

    resolve_device(args.device)  # raises when CUDA is asked for and absent
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
