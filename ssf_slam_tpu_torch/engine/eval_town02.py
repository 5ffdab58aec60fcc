"""The learned path on Town02 geometry with tracked movers (the port's
counterpart of scripts/eval_town02.py, with its flags plus ``--device``).

Builds a Town02 mover sequence (``data/town02.py::make_frames``: the map
``MAP_BIN`` names plus box-tracked vehicles), runs the fused SSF step (TFlow
in the SLAM loop, the joint seg head) and scores:

- the trajectory's ATE against the sensor poses;
- the flow's EPE3D / Acc3DR against the generated GT flow;
- the seg head's moving-class IoU against the box labels.

It prints one JSON line with the JAX script's keys:

    python -m ssf_slam_tpu_torch.engine.eval_town02 \
        --ckpt ssf_slam_tpu_torch/weights/ssf_r3ft2.npz \
        [--frames 30 --vehicles 5 --seed 7 --n-points 8192 --device cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ckpt", required=True,
                   help="TFlow weights: an npz, or a directory holding "
                        "best.npz")
    p.add_argument("--frames", type=int, default=30)
    p.add_argument("--vehicles", type=int, default=5)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--n-points", type=int, default=8192)
    p.add_argument("--net-dtype", default="bfloat16")
    p.add_argument("--neighbor-backend", default="banded")
    p.add_argument("--resample", type=int, default=1)
    p.add_argument("--variant", default="ssf")
    p.add_argument("--structures", action="store_true",
                   help="add procedural road-edge facades (observable "
                        "geometry; the bare map is planar, see "
                        "data/town02.py::map_structures)")
    p.add_argument("--out-json", default=None)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv)


def evaluate(args) -> dict:
    """The metrics of ``args`` (``parse_args``'s namespace) as a dict."""
    from ssf_slam_tpu_torch.cli import _build_model
    from ssf_slam_tpu_torch.config import PipelineConfig, Variant
    from ssf_slam_tpu_torch.data import town02
    from ssf_slam_tpu_torch.data.carla import pad_points
    from ssf_slam_tpu_torch.device import resolve_device
    from ssf_slam_tpu_torch.engine.evaluation import ate_rmse
    from ssf_slam_tpu_torch.engine.fused import run_sequence_fused
    from ssf_slam_tpu_torch.models.metrics import flow_metrics, seg_metrics

    dev = resolve_device(args.device)
    raw, poses = town02.make_frames(args.frames, n_vehicles=args.vehicles,
                                    seed=args.seed,
                                    structures=args.structures)
    n = args.n_points
    rng = np.random.default_rng(0)
    frames = []
    for k, fr in enumerate(raw):
        p1, m1, i1 = pad_points(fr["points1"], n, rng)
        p2, m2, _ = pad_points(fr["points2"], n, rng)
        frames.append(dict(
            pos1=p1, pos2=p2, gt=fr["flow"][i1].astype(np.float32),
            s_fg_mask=fr["s_fg_mask"][i1].astype(np.float32),
            mask1=m1, mask2=m2, time=k * 0.1))

    model = _build_model(args, "ssf")
    cfg = PipelineConfig(variant=Variant.SSF)

    # the trajectory through the fused network-in-the-loop step
    state, outs = run_sequence_fused(model, frames, cfg, device=dev,
                                     return_state=True)
    est = np.asarray(outs["pose_t"])
    ref = np.stack([poses[k][0] for k in range(len(est))])
    ate = float(ate_rmse(est, ref))

    # per-pair flow and seg metrics (the network on each pair, as eval-flow)
    fm, sm = [], []
    with torch.inference_mode():
        for f in frames:
            def t(a):
                return torch.as_tensor(np.asarray(a, np.float32),
                                       device=dev)[None]

            flows, _ = model(t(f["pos1"]), t(f["pos2"]))
            out = flows[0]  # metrics in its type, as the JAX script
            mask = t(f["mask1"])
            fm.append({k: float(v) for k, v in
                       flow_metrics(out[..., :3], t(f["gt"]), mask).items()})
            if out.shape[-1] > 3:
                sm.append({k: float(v) for k, v in seg_metrics(
                    out[..., 3], t(f["s_fg_mask"]), mask).items()})
    agg = {k: float(np.mean([m[k] for m in fm])) for k in fm[0]}
    if sm:
        agg.update({k: float(np.mean([m[k] for m in sm])) for k in sm[0]})
    agg["ate_m"] = ate
    agg["n_frames"] = len(frames)
    agg["n_vehicles"] = args.vehicles
    agg["n_loops"] = int(state.map_state.n_loops_total)
    return agg


def main(argv=None) -> int:
    args = parse_args(argv)
    agg = evaluate(args)
    print(json.dumps({k: round(v, 5) if isinstance(v, float) else v
                      for k, v in agg.items()}))
    if args.out_json:
        with open(args.out_json, "w") as fh:
            json.dump(agg, fh, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
