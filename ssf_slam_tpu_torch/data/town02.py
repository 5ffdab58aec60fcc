"""Scene-flow sequences off the CARLA Town02 road map, a copy of
ssf_slam_tpu/data/town02.py (plain numpy; the port imports nothing of the
JAX package).

``MAP_BIN`` names a recorded Town02 drivable-area point cloud (KITTI x, y,
z, intensity float32 rows). A virtual sensor drives through it, optionally
with tracked vehicle movers whose box motion and rotation delta enter the
flow (``data/sceneflow_gen.py``). Two consumers:
- ``ssf_slam_tpu_torch.data.make_town02_seq`` writes frame pairs in the
  FlowNet3D npz dialect, with a ``poses.tum``;
- ``training_frames`` gives routes in the trainer's key dialect (pos1,
  pos2, gt, s_fg_mask, mask1 at a fixed n_points), for
  ``train/train_ssf.py --town02-routes``.

The map is planar (all z = -2.5): yaw-only motion keeps every DoF the flow
observes exact. A scan is a range gate around the sensor pose plus the
rigid world-to-sensor transform. ``MAP_BIN`` is a module global, so that a
caller can point it at another map; it defaults to ``data/town02-map.bin``
at the repository's root, where the recorded map goes once it is committed
(the JAX package reads it from the reference project's checkout).
"""

from __future__ import annotations

import os

import numpy as np

MAP_BIN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "data", "town02-map.bin")


def _yaw(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def sensor_track(n: int, route_seed: int | None = None
                 ) -> list[tuple[np.ndarray, float]]:
    """A drive through Town02's populated block: straight + gentle turn.

    Stays inside the map's x in [-9, 195], y in [-308, -103] extent.
    ``route_seed`` varies the start pose / curvature (for corpus variety);
    None keeps the canonical route. Starts are drawn from a block
    of the map dense enough that the min_pts guard in make_frames holds.
    """
    if route_seed is None:
        pos, yaw, amp, sp = np.array([60.0, -250.0, 0.0]), 0.15, 0.012, 1.1
    else:
        rr = np.random.default_rng(route_seed)
        pos = np.array([float(rr.uniform(40.0, 120.0)),
                        float(rr.uniform(-270.0, -200.0)), 0.0])
        yaw = float(rr.uniform(-0.4, 0.4)) + float(rr.choice([0.0, np.pi]))
        amp = float(rr.uniform(0.004, 0.02))
        sp = float(rr.uniform(0.8, 1.4))
    poses = []
    for k in range(n + 1):
        poses.append((pos.copy(), yaw))
        yaw += amp * np.sin(k * 0.2)
        pos = pos + _yaw(yaw)[:, 0] * sp
    return poses


def vehicle_tracks(n_frames: int, n_vehicles: int, seed: int = 0,
                   dt: float = 0.1, route_seed: int | None = None):
    """Tracked vehicles driving along/near the sensor route, matching
    Generate_Sceneflow.py:498-523 semantics: each vehicle is a yawed bbox
    whose per-pair motion is a center displacement + yaw delta; its body is
    a surface-sampled point shell that moves rigidly with the box.

    Returns a list of per-vehicle dicts:
      {centers [n+1,3], yaws [n+1], size [3], body [P,3] (box-local)}.
    """
    rng = np.random.default_rng(seed)
    route = sensor_track(n_frames, route_seed)
    vehicles = []
    attempts = 0
    while len(vehicles) < n_vehicles and attempts < 50 * n_vehicles:
        attempts += 1
        # anchor near a random point of the sensor route, offset laterally
        # (a lane over), driving roughly along the local route direction
        k0 = int(rng.integers(0, n_frames))
        pos0, yaw0 = route[k0]
        lateral = float(rng.uniform(-6.0, 6.0))
        ahead = float(rng.uniform(5.0, 35.0))
        fwd = _yaw(yaw0)[:, 0]
        left = _yaw(yaw0)[:, 1]
        heading = yaw0 + float(rng.choice([0.0, np.pi])) + float(
            rng.normal(0, 0.1))
        speed = float(rng.uniform(2.0, 9.0))
        yaw_rate = float(rng.normal(0, 0.05))
        size = np.array([4.2, 1.9, 1.6]) * rng.uniform(0.9, 1.15)
        c0 = pos0 + fwd * ahead + left * lateral
        c0[2] = -2.5 + size[2] / 2  # body sits on the road (map z = -2.5)
        centers, yaws = [], []
        c, h = c0.copy(), heading
        for k in range(n_frames + 1):
            centers.append(c.copy())
            yaws.append(h)
            c = c + _yaw(h)[:, 0] * speed * dt
            h += yaw_rate * dt
        centers = np.asarray(centers)
        # reject tracks that ever come within 7 m of an accepted vehicle:
        # overlapping boxes are unphysical AND ill-posed (a point inside
        # two boxes has no single object motion — the production generator
        # and the oracle would legitimately disagree there)
        too_close = any(
            float(np.min(np.linalg.norm(
                centers[:, :2] - other["centers"][:, :2], axis=1))) < 7.0
            for other in vehicles
        )
        if too_close:
            continue
        # box-local surface shell (roof + 4 sides), LiDAR-like coverage
        n_body = 220
        u = rng.uniform(-0.5, 0.5, (n_body, 2))
        face = rng.integers(0, 5, n_body)
        body = np.zeros((n_body, 3), np.float32)
        sx, sy, sz = size
        body[face == 0] = np.stack(  # roof
            [u[face == 0, 0] * sx, u[face == 0, 1] * sy,
             np.full((face == 0).sum(), sz / 2)], 1)
        for f, (ax, sgn) in enumerate(((0, 1), (0, -1), (1, 1), (1, -1)),
                                      start=1):
            sel = face == f
            w = np.zeros((sel.sum(), 3), np.float32)
            w[:, ax] = sgn * (size[ax] / 2)
            w[:, 1 - ax] = u[sel, 0] * size[1 - ax]
            w[:, 2] = (u[sel, 1]) * sz
            body[sel] = w
        vehicles.append(dict(centers=centers,
                             yaws=np.asarray(yaws), size=size,
                             body=body))
    return vehicles


def map_structures(seed: int = 0, cell: float = 2.0, p_build: float = 0.6,
                   density: int = 40) -> np.ndarray:
    """Procedural building facades anchored to the REAL road map.

    The recorded town02-map.bin is the drivable area only, and it is planar
    (all z = -2.5) — in-plane ego-motion is UNOBSERVABLE from it (the
    aperture problem: a flat road looks identical slid along itself).
    Measured consequence: even with near-perfect segmentation (moving-IoU
    0.985 after the round-5 fine-tune) the map-only scene tracks at ~1.4-
    1.7 m ATE because neither learned flow nor point-to-plane refinement
    can recover what the geometry does not constrain. Real Town02 LiDAR
    scans (the reference's recorded sequences, Process.py) see building
    facades along the streets; this reconstructs that observability:
    point-sampled vertical walls extruded on occupancy-grid cells ADJACENT
    to the road (where Town02's facades actually stand), deterministic in
    ``seed``. Returns [P, 3] static world points (flow semantics: rigid
    ego-flow, s_fg_mask = 0, exactly like the map points).
    """
    m = np.fromfile(MAP_BIN, np.float32).reshape(-1, 4)[:, :3]
    lo = m[:, :2].min(0)
    g = np.floor((m[:, :2] - lo) / cell).astype(np.int64)
    shape = tuple(g.max(0) + 1)
    occ = np.zeros(shape, bool)
    occ[g[:, 0], g[:, 1]] = True
    # edge cells: unoccupied, 8-adjacent to road
    pad = np.pad(occ, 1)
    neigh = np.zeros_like(occ)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            if dx or dy:
                neigh |= pad[1 + dx:1 + dx + shape[0],
                             1 + dy:1 + dy + shape[1]]
    edge = neigh & ~occ
    cells = np.argwhere(edge)
    rng = np.random.default_rng(909 + seed)
    keep = cells[rng.random(len(cells)) < p_build]
    pts = []
    for cx, cy in keep:
        h = float(rng.uniform(2.5, 7.0))  # facade height per cell
        u = rng.uniform(0, 1, (density, 3)).astype(np.float32)
        w = np.empty((density, 3), np.float32)
        w[:, 0] = lo[0] + (cx + u[:, 0]) * cell
        w[:, 1] = lo[1] + (cy + u[:, 1]) * cell
        w[:, 2] = -2.5 + u[:, 2] * h
        pts.append(w)
    return (np.concatenate(pts, 0) if pts
            else np.zeros((0, 3), np.float32))


def make_frames(n_frames: int, radius: float = 60.0, min_pts: int = 512,
                n_vehicles: int = 0, seed: int = 0,
                route_seed: int | None = None,
                structures: bool = False):
    """Frame pairs off the real Town02 map, optionally with tracked movers.

    With ``n_vehicles`` > 0, each frame's clouds include the vehicles'
    surface shells at their per-frame poses, the flow inside each bbox
    carries the object's own motion + rotation delta
    (data/sceneflow_gen.py::compute_pairwise_scene_flow, matching
    Generate_Sceneflow.py:498-523), and ``s_fg_mask`` labels mover points.

    ``structures=True`` adds procedural facades along the road edges
    (``map_structures``): without them the map-only world is planar and
    in-plane ego-motion is unobservable — see map_structures' docstring.
    """
    from ssf_slam_tpu_torch.data.sceneflow_gen import (
        ObjectTrack,
        compute_pairwise_scene_flow,
    )

    m = np.fromfile(MAP_BIN, np.float32).reshape(-1, 4)[:, :3]
    if structures:
        m = np.concatenate([m, map_structures(seed=seed)], 0)
    poses = sensor_track(n_frames, route_seed)
    vehicles = vehicle_tracks(n_frames, n_vehicles, seed=seed,
                              route_seed=route_seed)
    frames = []
    for k in range(n_frames):
        (p1, y1), (p2, y2) = poses[k], poses[k + 1]
        r1, r2 = _yaw(y1), _yaw(y2)

        def world_cloud(frame_idx):
            clouds = [m]
            for veh in vehicles:
                c = veh["centers"][frame_idx]
                yw = veh["yaws"][frame_idx]
                clouds.append(veh["body"] @ _yaw(yw).T + c)
            return np.concatenate(clouds, 0)

        def view(pw, p, r):
            d = np.linalg.norm(pw[:, :2] - p[None, :2], axis=1)
            sel = pw[d < radius]
            return ((sel - p) @ r).astype(np.float32)  # world -> sensor

        pts1 = view(world_cloud(k), p1, r1)
        pts2 = view(world_cloud(k + 1), p2, r2)
        assert len(pts1) > min_pts and len(pts2) > min_pts, (
            f"frame {k}: track left the mapped area ({len(pts1)} pts)")
        tracks = [
            ObjectTrack(
                center1=veh["centers"][k], size=veh["size"] + 0.2,
                yaw1=float(veh["yaws"][k]),
                center2=veh["centers"][k + 1],
                yaw2=float(veh["yaws"][k + 1]),
            )
            for veh in vehicles
        ]
        # (r, t) convention: p_world = p_sensor @ r.T + t. view() maps
        # w -> (w - p) @ r, whose inverse is w = s @ r.T + p, so the
        # world-from-sensor rotation argument is r itself. (Round 4 passed
        # r.T here AND in the oracle test — a shared transposition that the
        # rigid yaw-only path masked; bbox movers exposed it because
        # points_in_box then reconstructed world points wrongly and no
        # point ever fell inside a box.)
        gt, _, fg = compute_pairwise_scene_flow(
            pts1, r1, p1, r2, p2, objects=tracks)
        fr = dict(points1=pts1, points2=pts2, flow=gt.astype(np.float32),
                  valid_mask1=np.ones(len(pts1), bool))
        if n_vehicles:
            fr["s_fg_mask"] = fg.astype(np.float32)
        frames.append(fr)
    return frames, poses


def training_frames(n_routes: int, frames_per_route: int,
                    n_points: int = 8192, n_vehicles: int = 4,
                    seed_base: int = 0, fg_oversample: int = 0,
                    structures: bool = True) -> list[dict]:
    """Town02-map frame pairs in the trainer's key dialect.

    Each route draws a distinct start pose / heading / curvature
    (``route_seed``) and its own vehicle placement seed; every frame pair is
    subsampled to ``n_points`` (hybrid FG/BG when ``fg_oversample`` > 0 —
    carla.py:179-200 parity — otherwise uniform) and emitted as
    {pos1, pos2, gt, s_fg_mask, mask1}, the exact keys
    ``train.harness.batcher`` stacks. Deterministic in ``seed_base``.
    """
    from ssf_slam_tpu_torch.data.carla import hybrid_sample, pad_points

    rng = np.random.default_rng(2026 + seed_base)
    out = []
    for r in range(n_routes):
        raw, _ = make_frames(
            frames_per_route, n_vehicles=n_vehicles,
            seed=seed_base + 17 * r, route_seed=seed_base + 31 * r + 1,
            structures=structures)
        for fr in raw:
            fg = fr.get("s_fg_mask",
                        np.zeros(len(fr["points1"]), np.float32))
            if fg_oversample and len(fr["points1"]) >= n_points:
                i1 = hybrid_sample(fg, n_points, fg_oversample, rng)
                pos1 = fr["points1"][i1]
                m1 = np.ones(n_points, bool)
            else:
                pos1, m1, i1 = pad_points(fr["points1"], n_points, rng)
            pos2, _, _ = pad_points(fr["points2"], n_points, rng)
            out.append(dict(
                pos1=pos1.astype(np.float32), pos2=pos2.astype(np.float32),
                gt=fr["flow"][i1].astype(np.float32),
                s_fg_mask=fg[i1].astype(np.float32) * m1,
                mask1=m1,
            ))
    return out
