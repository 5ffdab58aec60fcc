"""The benchmark's traffic generator: synthetic CARLA-style scene-flow
drives, copied from ssf_slam_tpu_torch/data/synthetic.py (same seed, the
same frames).

An analytic ray-cast world (ground plane, static boxes, moving boxes) and
an ego trajectory give frame pairs {pos1, pos2, gt, ego_flow, s_fg_mask,
t_fg_mask, mask1, mask2, pose1, pose2, time}; ``pos1 + gt`` lies on the
frame-2 geometry in frame-2 sensor coordinates, and ``s_fg_mask`` marks
frame-1 points on moving objects. Host-side NumPy.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np



def hybrid_sample(
    fg_mask: np.ndarray,  # [M] bool/0-1 moving-point labels
    n: int,
    num_fg: int,
    rng: np.random.Generator,
) -> np.ndarray:
    """Foreground-oversampled subsampling (hybrid_sample_points,
    utils/datasets/carla.py:179-200).

    Picks ``num_fg`` moving points (ALL of them when fewer exist, background
    filling the remainder) plus background for the rest — the training-
    balance lever for scenes where movers are a small minority. Returns n
    SORTED indices into the original array (sorted, unlike the reference's
    hstack order, so downstream per-ring curvature windows stay meaningful).
    Requires n <= len(fg_mask).
    """
    fg = np.flatnonzero(fg_mask > 0.5)
    bg = np.flatnonzero(fg_mask <= 0.5)
    n_fg = min(num_fg, len(fg))
    sel_fg = fg if n_fg == len(fg) else rng.choice(fg, n_fg, replace=False)
    n_bg = n - n_fg
    # replacement fallback when a class can't fill its share — the
    # reference's loader resamples with replacement in the same situation
    # (carla.py:274-285); mover-heavy frames can leave a tiny background
    if n_bg == 0:
        sel_bg = np.zeros(0, np.int64)
    elif len(bg) == 0:  # all-mover frame: fall back to foreground
        sel_bg = rng.choice(fg, n_bg, replace=True)
    else:
        sel_bg = rng.choice(bg, n_bg, replace=len(bg) < n_bg)
    return np.sort(np.concatenate([sel_fg, sel_bg]))


@dataclasses.dataclass
class Box:
    center: np.ndarray  # [3]
    size: np.ndarray  # [3] full extents
    velocity: np.ndarray  # [3] m/s (zero => static)
    yaw_rate: float = 0.0  # rad/s about z through center

    def at(self, t: float) -> "Box":
        return Box(
            center=self.center + self.velocity * t,
            size=self.size,
            velocity=self.velocity,
            yaw_rate=self.yaw_rate,
        )


@dataclasses.dataclass
class SyntheticWorld:
    """Analytic world: ground plane z=0 + axis-aligned boxes (pre-rotation)."""

    boxes: list
    extent: float = 60.0  # bounding wall distance

    @staticmethod
    def traffic_scene(
        rng: np.random.Generator,
        n_static: int = 12,
        n_moving: int = 4,
        extent: float = 60.0,
        mover_speed: tuple = (3.0, 10.0),
        crossing_frac: float = 0.0,
    ) -> "SyntheticWorld":
        """A CARLA-like street: buildings (static boxes) + vehicles (movers)."""
        boxes = []
        # perimeter walls enclose the block (continuous frontage, as real
        # towns have): long facades guarantee plane-feature observability in
        # every horizontal direction at every trajectory point
        w = extent
        for c, s in (
            ((0.0, w, 0.0), (2 * w, 1.0, 7.0)),
            ((0.0, -w, 0.0), (2 * w, 1.0, 7.0)),
            ((w, 0.0, 0.0), (1.0, 2 * w, 7.0)),
            ((-w, 0.0, 0.0), (1.0, 2 * w, 7.0)),
        ):
            c = np.array(c)
            s = np.array(s, float)
            c[2] = s[2] / 2
            boxes.append(Box(c, s, np.zeros(3)))
        for _ in range(n_static):
            # buildings line the street: elongated facades whose INNER EDGE
            # starts at 5-16 m lateral distance (CARLA-town-like frontage;
            # near facades keep the along-road axis observable for
            # registration). Placement is by inner edge, not center:
            # centering at 8-22 m with up to 12 m depth could push a facade
            # to |y| = 2, INSIDE the driving corridor — a seed-21 world
            # boxed the ego in and produced empty scans mid-sequence.
            s = rng.uniform([10, 4, 3], [30, 12, 9])
            side = rng.choice([-1.0, 1.0])
            inner = rng.uniform(5.0, 16.0)
            c = np.array(
                [
                    rng.uniform(-extent * 0.8, extent * 0.8),
                    side * (inner + s[1] / 2),
                    0.0,
                ]
            )
            c[2] = s[2] / 2
            boxes.append(Box(c, s, np.zeros(3)))
        # street furniture: parked cars / kiosks along the road edges — the
        # near-field structure real streets have, constraining all horizontal
        # directions at close range
        for _ in range(2 * n_static):
            s = rng.uniform([1.5, 1.5, 1.0], [4.5, 2.2, 2.2])
            c = np.array(
                [
                    rng.uniform(-extent * 0.9, extent * 0.9),
                    # inner edge >= 4.2 m: clear of the |y| <= 3.5 corridor
                    rng.choice([-1.0, 1.0]) * (rng.uniform(4.2, 6.5)
                                               + s[1] / 2),
                    0.0,
                ]
            )
            c[2] = s[2] / 2
            boxes.append(Box(c, s, np.zeros(3)))
        for _ in range(n_moving):
            c = np.array([rng.uniform(-extent * 0.6, extent * 0.6),
                          rng.uniform(-5.0, 5.0), 0.9])
            s = np.array([4.5, 2.0, 1.8])
            speed = rng.uniform(*mover_speed)
            if rng.uniform() < crossing_frac:
                # crossing traffic: mostly-lateral motion — flow differs
                # from ego flow in DIRECTION rather than magnitude, a harder
                # case for the seg head than along-road movers
                th = rng.uniform(np.pi / 3, 2 * np.pi / 3) * rng.choice([-1, 1])
            else:
                th = 0.0 if rng.uniform() < 0.5 else np.pi
            v = speed * np.array([np.cos(th), np.sin(th), 0.0])
            boxes.append(Box(c, s, v))
        return SyntheticWorld(boxes=boxes, extent=extent)


def _ray_box(o: np.ndarray, d: np.ndarray, box: Box) -> tuple[np.ndarray, np.ndarray]:
    """Slab-method ray/AABB intersection.

    o [3], d [R, 3] -> (t [R] entry distance or inf, hit [R] bool).
    """
    lo = box.center - box.size / 2
    hi = box.center + box.size / 2
    with np.errstate(divide="ignore", invalid="ignore"):
        t0 = (lo[None] - o[None]) / d
        t1 = (hi[None] - o[None]) / d
    tmin = np.nanmax(np.minimum(t0, t1), axis=-1)
    tmax = np.nanmin(np.maximum(t0, t1), axis=-1)
    hit = (tmax >= tmin) & (tmax > 0)
    t = np.where(hit, np.maximum(tmin, 1e-6), np.inf)
    return t, hit


def _scan_directions(
    n_rows: int, pts_per_row: int, rng: Optional[np.random.Generator] = None
) -> np.ndarray:
    """[n_rows * pts_per_row, 3] unit ray directions (sensor frame).

    16-row geometry matching src/frameFeature.cpp:58-61: elevations
    -15..+15 deg at 2 deg pitch. 64-row geometry matches the HDL-64 model
    of src/frameFeature.cpp:64-71 (the one assign_scan_rows inverts): upper
    32 rows from +2 deg at 1/3 deg pitch, lower 32 from -8.83 deg at
    1/2 deg pitch.
    """
    if n_rows == 64:
        upper = 2.0 - np.arange(32) / 3.0
        lower = -8.83 - np.arange(32) / 2.0
        elevs = np.radians(np.concatenate([upper, lower]))
    else:
        elevs = np.radians(np.linspace(-15, 15, n_rows))
    az = np.linspace(-np.pi, np.pi, pts_per_row, endpoint=False)
    if rng is not None:
        az = az + rng.uniform(0, 2 * np.pi / pts_per_row)
    e, a = np.meshgrid(elevs, az, indexing="ij")
    d = np.stack(
        [np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)], axis=-1
    )
    return d.reshape(-1, 3)


def _yaw_matrix(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def simulate_scan(
    world: SyntheticWorld,
    sensor_pos: np.ndarray,
    sensor_yaw: float,
    t: float,
    n_rows: int = 16,
    pts_per_row: int = 512,
    max_range: float = 80.0,
    noise: float = 0.0,
    rng: Optional[np.random.Generator] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Ray-cast one scan.

    Returns (points [R, 3] in sensor frame, hit_mask [R], object_id [R])
    where object_id is -1 ground/wall, i >= 0 for boxes[i].
    """
    dirs_s = _scan_directions(n_rows, pts_per_row, rng)
    r_ws = _yaw_matrix(sensor_yaw)
    dirs_w = dirs_s @ r_ws.T
    o = sensor_pos

    best_t = np.full(len(dirs_w), np.inf)
    obj_id = np.full(len(dirs_w), -1, dtype=np.int32)

    # ground plane z = 0
    dz = dirs_w[:, 2]
    with np.errstate(divide="ignore"):
        tg = np.where(dz < -1e-6, -o[2] / dz, np.inf)
    best_t = np.minimum(best_t, tg)

    for i, box in enumerate(world.boxes):
        b = box.at(t)
        tb, hit = _ray_box(o, dirs_w, b)
        closer = hit & (tb < best_t)
        best_t = np.where(closer, tb, best_t)
        obj_id = np.where(closer, i, obj_id)

    hit_mask = np.isfinite(best_t) & (best_t < max_range) & (best_t > 0.5)
    pts_s = dirs_s * np.where(hit_mask, best_t, 0.0)[:, None]
    if noise > 0 and rng is not None:
        pts_s = pts_s + rng.normal(scale=noise, size=pts_s.shape)
    return pts_s.astype(np.float32), hit_mask, obj_id


def subsample_scan(
    pts: np.ndarray,
    mask: np.ndarray,
    oid: np.ndarray,
    n: int,
    rng: np.random.Generator,
    fg_oversample: int = 0,
    moving_ids: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Random-subsample valid hits to exactly n padded rows, kept in their
    original (row-major, azimuth-sorted) order
    (utils/datasets/carla.py:274-285). ``fg_oversample`` > 0 draws up to
    that many points from the moving objects ``moving_ids`` and the rest
    from the background (``data/carla.py::hybrid_sample``): the training
    balance lever; 0 for evaluation data."""
    hits = np.flatnonzero(mask)
    if len(hits) > n:
        if fg_oversample > 0 and moving_ids is not None:
            fg = np.isin(oid[hits], moving_ids)
            sel = hits[hybrid_sample(fg, n, fg_oversample, rng)]
        else:
            sel = np.sort(rng.choice(hits, n, replace=False))
    else:
        sel = hits
    out_p = np.zeros((n, 3), pts.dtype)
    out_m = np.zeros(n, bool)
    out_o = np.full(n, -1, np.int32)
    k = len(sel)
    out_p[:k] = pts[sel]
    out_m[:k] = True
    out_o[:k] = oid[sel]
    return out_p, out_m, out_o


def _serpentine(step: int, n_steps: int, radius: float = 30.0):
    """Default ego trajectory: gentle lane-weaving drive down the street.

    Stays inside the world's clear corridor (|y| < 5), advances ~1.2 m/frame
    with bounded, physically-plausible yaw rates. (Loop-closure behavior is
    exercised by dedicated mapping tests with revisiting trajectories; a
    generic closed circuit would leave the corridor and clip the buildings.)
    """
    del n_steps, radius
    speed = 1.2
    x = speed * step - 45.0  # start near one end of the street
    y = 3.0 * np.sin(0.06 * step)
    dy = 3.0 * 0.06 * np.cos(0.06 * step)
    yaw = np.arctan2(dy, speed)
    return np.array([x, y, 1.8]), float(yaw)


def speed_profile(speeds, n_steps: int):
    """The serpentine street drive with the ego's advance per scan taken
    in turn from ``speeds`` (metres): the lane weave follows the distance
    driven (``_serpentine``'s at 1.2 m a scan), so a slower scan turns
    less. Returns ``trajectory(step) -> (position, yaw)``."""
    dist = np.concatenate([[0.0], np.cumsum(np.resize(
        np.asarray(speeds, np.float64), n_steps))])
    w = 0.06 / 1.2

    def trajectory(step: int):
        s = dist[step]
        yaw = np.arctan2(3.0 * w * np.cos(w * s), 1.0)
        return np.array([s - 45.0, 3.0 * np.sin(w * s), 1.8]), float(yaw)

    return trajectory


def _out_and_back(step: int, n_steps: int, radius: float = 30.0):
    """Closed-circuit trajectory: drive down the street, U-turn, drive back.

    Revisits the outbound lane ~4 m away on the return leg, so the
    loop-closure search (radius 15 m, >20 s separation,
    src/mapOptmization.cpp:168-198) fires near the end of the sequence —
    the serpentine street drive never revisits, which is why round-1 chip
    runs never closed a loop. Stays inside the |y| < 5 clear corridor.
    """
    del radius
    speed = 1.2
    n_turn = 26  # ~7 deg/frame peak yaw rate — scan-to-scan tracks it
    n_leg = max((n_steps + 1 - n_turn) // 2, 1)
    turn_r = 1.5
    x0, y_out, z = -45.0, -2.0, 1.8
    # gentle lane weave on both legs: a perfectly straight corridor drive
    # leaves the along-road axis geometrically unobservable for scan-to-scan
    # registration (docs/PERFORMANCE.md corridor note); real cars weave
    wamp, wfreq = 0.8, 0.25
    if step < n_leg:  # outbound
        y = y_out + wamp * np.sin(wfreq * step)
        dy = wamp * wfreq * np.cos(wfreq * step)
        return (np.array([x0 + speed * step, y, z]),
                float(np.arctan2(dy, speed)))
    if step < n_leg + n_turn:  # U-turn (left semicircle)
        th = np.pi * (step - n_leg + 1) / (n_turn + 1)  # 0..pi
        cx = x0 + speed * (n_leg - 1)
        x = cx + turn_r * np.sin(th)
        y = y_out + turn_r * (1.0 - np.cos(th))
        return np.array([x, y, z]), float(th)
    # return leg
    k = step - n_leg - n_turn + 1
    y_ret = y_out + 2 * turn_r
    y = y_ret + wamp * np.sin(wfreq * k)
    dy = wamp * wfreq * np.cos(wfreq * k)
    return (
        np.array([x0 + speed * (n_leg - 1) - speed * k, y, z]),
        float(np.pi - np.arctan2(dy, speed)),
    )


TRAJECTORIES = {"street": _serpentine, "loop": _out_and_back}


def generate_sequence(
    n_frames: int = 40,
    n_points: int = 8192,
    n_rows: int = 16,
    dt: float = 0.1,
    seed: int = 0,
    noise: float = 0.0,
    n_moving: int = 4,
    radius: float = 30.0,
    trajectory=None,
    mover_speed: tuple = (3.0, 10.0),
    crossing_frac: float = 0.0,
    fg_oversample: int = 0,
) -> list[dict]:
    """Generate a CARLA-npz-schema sequence of frame PAIRS.

    Each element matches utils/datasets/carla.py:455-465 consumption:
    {pos1, pos2, gt, ego_flow, s_fg_mask, t_fg_mask, pose1(q,t), pose2,
     time} — poses are extras (world-from-sensor ground truth) the reference
    keeps in its CARLA pose logs.
    """
    rng = np.random.default_rng(seed)
    world = SyntheticWorld.traffic_scene(
        rng, n_moving=n_moving, mover_speed=mover_speed,
        crossing_frac=crossing_frac)
    if isinstance(trajectory, str):
        traj_fn = TRAJECTORIES[trajectory]
        traj = lambda k: traj_fn(k, n_frames, radius)  # noqa: E731
    else:
        traj = trajectory or (lambda k: _serpentine(k, n_frames, radius))

    # cast dense (like a real sensor), then random-subsample to n_points —
    # exactly the density regime of the reference's CARLA npz frames
    pts_per_row = max(1024, int(np.ceil(n_points / n_rows)))
    moving_ids = np.asarray(
        [i for i, b in enumerate(world.boxes) if np.any(b.velocity)])
    frames = []
    scans = []
    for k in range(n_frames + 1):
        pos, yaw = traj(k)
        t = k * dt
        p, m, oid = simulate_scan(
            world, pos, yaw, t, n_rows, pts_per_row, noise=noise, rng=rng
        )
        p, m, oid = subsample_scan(p, m, oid, n_points, rng,
                                   fg_oversample=fg_oversample,
                                   moving_ids=moving_ids)
        scans.append((p, m, oid, pos, yaw, t))

    for k in range(n_frames):
        p1, m1, oid1, pos1_w, yaw1, t1 = scans[k]
        p2, m2, oid2, pos2_w, yaw2, t2 = scans[k + 1]
        r1, r2 = _yaw_matrix(yaw1), _yaw_matrix(yaw2)

        # rigid ego-flow: frame1 sensor coords -> frame2 sensor coords
        # (Generate_Sceneflow.py:432-436: arr_ = (arr @ Rsrc^-T + tsrc - ttgt) @ Rtgt^T
        #  with row-vector convention; equivalently R2^T (R1 p + t1 - t2))
        pw = p1 @ r1.T + pos1_w  # world coords of frame-1 points
        ego_warp = (pw - pos2_w) @ r2
        ego_flow = ego_warp - p1

        # object motion: points inside moving boxes get the box displacement
        gt = ego_flow.copy()
        fg1 = np.zeros(len(p1), dtype=np.float32)
        for i, box in enumerate(world.boxes):
            if not np.any(box.velocity):
                continue
            on_obj = oid1 == i
            if not on_obj.any():
                continue
            disp_w = box.velocity * (t2 - t1)
            moved_w = pw[on_obj] + disp_w
            gt[on_obj] = (moved_w - pos2_w) @ r2 - p1[on_obj]
            fg1[on_obj] = 1.0
        fg2 = np.isin(oid2, [i for i, b in enumerate(world.boxes)
                             if np.any(b.velocity)]).astype(np.float32)

        frames.append(
            dict(
                pos1=p1.astype(np.float32),
                pos2=p2.astype(np.float32),
                gt=gt.astype(np.float32),
                ego_flow=ego_flow.astype(np.float32),
                s_fg_mask=fg1 * m1,
                t_fg_mask=fg2 * m2,
                mask1=m1,
                mask2=m2,
                pose1=(r1, pos1_w),
                pose2=(r2, pos2_w),
                time=t1,
            )
        )
    return frames

