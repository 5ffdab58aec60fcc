"""Write a KITTI/FlowNet3D-dialect scene-flow sequence off the Town02 road
map (the port's counterpart of scripts/make_town02_seq.py, with its flags).

One npz per frame pair in the FlowNet3D key dialect (``points1``,
``points2``, ``flow``, ``valid_mask1``, and ``s_fg_mask`` with vehicles),
plus a ``poses.tum`` of the sensor poses, from ``data/town02.py`` (its
``MAP_BIN`` names the map):

    python -m ssf_slam_tpu_torch.data.make_town02_seq --out SEQ --frames 30
    python -m ssf_slam_tpu_torch.cli run --variant seg --dataset SEQ \
        --dataset-kind kitti_fn3d --n-points 4096 --out town02.tum
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from ssf_slam_tpu_torch.data import town02


def write_sequence(out: str, frames: list, poses: list) -> None:
    """The frame pairs as ``%06d.npz`` and the first ``len(frames)``
    sensor poses as ``poses.tum`` (yaw-only quaternions, 10 Hz)."""
    os.makedirs(out, exist_ok=True)
    for k, fr in enumerate(frames):
        np.savez(os.path.join(out, f"{k:06d}.npz"), **fr)
    with open(os.path.join(out, "poses.tum"), "w") as fh:
        for k in range(len(frames)):
            p, y = poses[k]
            qw, qz = np.cos(y / 2), np.sin(y / 2)
            fh.write(f"{k * 0.1:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                     f"0.000000 0.000000 {qz:.6f} {qw:.6f}\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--vehicles", type=int, default=0,
                    help="tracked movers on the map (box motion + rotation "
                         "delta in the flow; writes s_fg_mask)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--route-seed", type=int, default=None,
                    help="vary start pose / heading / curvature (None = "
                         "the canonical route)")
    ap.add_argument("--structures", action="store_true",
                    help="add procedural road-edge facades (the map alone "
                         "is planar, so in-plane motion is unobservable; "
                         "see data/town02.py::map_structures)")
    args = ap.parse_args(argv)
    frames, poses = town02.make_frames(
        args.frames, n_vehicles=args.vehicles, seed=args.seed,
        route_seed=args.route_seed, structures=args.structures)
    write_sequence(args.out, frames, poses)
    print(f"wrote {len(frames)} Town02 frame pairs to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
