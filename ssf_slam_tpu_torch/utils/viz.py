"""Visualization utilities: the port's copy of ``ssf_slam_tpu/utils/viz.py``.

The reference's viz stack (utils/flow_vis.py's colormap, the BEV panels of
main_sju_occ_addSeg_Pointnet2_ros.py, vis_map.py) as numpy: flow colours,
BEV rasters, a PPM writer and PLY export. ``map_to_ply`` reads the port's
``MapState`` (clouds [K, F, 3], host cursors).
"""

from __future__ import annotations

import numpy as np


def _flow_colorwheel() -> np.ndarray:
    """Standard Middlebury-style color wheel (55 entries, RGB 0..255)."""
    ry, yg, gc, cb, bm, mr = 15, 6, 4, 11, 13, 6
    wheel = np.zeros((ry + yg + gc + cb + bm + mr, 3))
    col = 0
    wheel[:ry, 0] = 255
    wheel[:ry, 1] = np.floor(255 * np.arange(ry) / ry)
    col += ry
    wheel[col:col + yg, 0] = 255 - np.floor(255 * np.arange(yg) / yg)
    wheel[col:col + yg, 1] = 255
    col += yg
    wheel[col:col + gc, 1] = 255
    wheel[col:col + gc, 2] = np.floor(255 * np.arange(gc) / gc)
    col += gc
    wheel[col:col + cb, 1] = 255 - np.floor(255 * np.arange(cb) / cb)
    wheel[col:col + cb, 2] = 255
    col += cb
    wheel[col:col + bm, 2] = 255
    wheel[col:col + bm, 0] = np.floor(255 * np.arange(bm) / bm)
    col += bm
    wheel[col:col + mr, 2] = 255 - np.floor(255 * np.arange(mr) / mr)
    wheel[col:col + mr, 0] = 255
    return wheel


def flow_to_color(flow_xy: np.ndarray, max_mag: float | None = None) -> np.ndarray:
    """[N, 2] planar flow -> [N, 3] uint8 colors (flow_vis.py equivalent)."""
    wheel = _flow_colorwheel()
    n_cols = len(wheel)
    u, v = flow_xy[:, 0], flow_xy[:, 1]
    mag = np.sqrt(u * u + v * v)
    if max_mag is None:
        max_mag = max(float(mag.max()), 1e-6)
    mag = np.clip(mag / max_mag, 0, 1)
    ang = np.arctan2(-v, -u) / np.pi  # [-1, 1]
    fk = (ang + 1) / 2 * (n_cols - 1)
    k0 = np.floor(fk).astype(int) % n_cols
    k1 = (k0 + 1) % n_cols
    f = (fk - np.floor(fk))[:, None]
    col = (1 - f) * wheel[k0] / 255 + f * wheel[k1] / 255
    col = 1 - mag[:, None] * (1 - col)  # desaturate small flow
    return (col * 255).astype(np.uint8)


def bev_image(
    points: np.ndarray,
    colors: np.ndarray | None = None,
    extent: float = 60.0,
    resolution: int = 512,
) -> np.ndarray:
    """Rasterize points (+ optional per-point colors) into a BEV uint8 image."""
    img = np.zeros((resolution, resolution, 3), np.uint8)
    ij = np.floor((points[:, :2] + extent) / (2 * extent) * resolution)
    keep = np.all((ij >= 0) & (ij < resolution), axis=1)
    ij = ij[keep].astype(int)
    c = colors[keep] if colors is not None else np.full((keep.sum(), 3), 255,
                                                       np.uint8)
    img[resolution - 1 - ij[:, 1], ij[:, 0]] = c
    return img


def segmentation_panel(
    points: np.ndarray,
    masks: dict,
    extent: float = 60.0,
    resolution: int = 384,
) -> np.ndarray:
    """Side-by-side BEV comparison of segmentations (the 3x2 panel equivalent
    of the SSF variant's matplotlib figure): moving points red, static green.
    """
    panels = []
    for name, mask in masks.items():
        colors = np.where(
            np.asarray(mask)[:, None],
            np.array([[220, 60, 60]], np.uint8),
            np.array([[60, 200, 60]], np.uint8),
        )
        panels.append(bev_image(points, colors, extent, resolution))
    return np.concatenate(panels, axis=1)


def save_ppm(path: str, img: np.ndarray) -> None:
    """Dependency-free image writer (PPM P6)."""
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.astype(np.uint8).tobytes())


def project_labels_to_bev(
    points: np.ndarray,
    labels: np.ndarray,
    extent: float = 60.0,
    resolution: int = 512,
) -> np.ndarray:
    """Per-cell label image from labeled points (utils/get2Dlabel.py
    equivalent, BEV instead of camera projection): majority label per cell,
    255 = empty."""
    img = np.full((resolution, resolution), 255, np.uint8)
    votes = {}
    ij = np.floor((points[:, :2] + extent) / (2 * extent) * resolution)
    keep = np.all((ij >= 0) & (ij < resolution), axis=1)
    ij = ij[keep].astype(int)
    lab = np.asarray(labels)[keep].astype(int)
    flat = ij[:, 0] * resolution + ij[:, 1]
    for cls in np.unique(lab):
        counts = np.bincount(flat[lab == cls], minlength=resolution**2)
        votes[cls] = counts
    if votes:
        stack = np.stack([votes[c] for c in sorted(votes)], axis=0)
        best = np.argmax(stack, axis=0)
        nonzero = stack.sum(0) > 0
        classes = np.array(sorted(votes))
        img_flat = img.reshape(-1)
        img_flat[nonzero] = classes[best[nonzero]]
    return img.reshape(resolution, resolution)


def write_ply(path: str, points: np.ndarray,
              colors: np.ndarray | None = None) -> None:
    """Binary little-endian PLY point cloud (viewable in any 3D tool).

    The reference inspects maps through Open3D windows (vis_map.py,
    utils/testo3d.py); headless hosts export portable files instead.
    ``points`` [N, 3] float; ``colors`` [N, 3] uint8 optional.
    """
    pts = np.ascontiguousarray(points, np.float32)
    n = len(pts)
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {n}",
               "property float x", "property float y", "property float z"]
        if colors is not None:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr.append("end_header")
        f.write(("\n".join(hdr) + "\n").encode())
        if colors is None:
            f.write(pts.tobytes())
        else:
            cols = np.ascontiguousarray(colors, np.uint8)
            rec = np.zeros(n, dtype=[("xyz", np.float32, 3),
                                     ("rgb", np.uint8, 3)])
            rec["xyz"] = pts
            rec["rgb"] = cols
            f.write(rec.tobytes())


def map_to_ply(map_state, path: str, trajectory: bool = True,
               stride: int = 1) -> int:
    """Export the SLAM keyframe map (+ trajectory, red) as one PLY.

    Aggregates every stored keyframe feature cloud into the map frame
    using the OPTIMIZED keyframe poses (mapOptmization.cpp rebuilds the
    aggregated map cloud the same way after loop corrections, :315-332),
    coloring points by keyframe index (viridis-ish ramp). Past
    ``max_keyframes`` only the stored rows are exported. Returns the number
    of exported points.
    """
    from ssf_slam_tpu_torch.ops.se3 import quat_rotate

    n_kf = min(int(map_state.n_kf), map_state.kf_q.shape[0])
    kf_cloud = map_state.kf_cloud.detach().cpu()
    kf_mask = map_state.kf_cloud_mask.detach().cpu()
    kf_q = map_state.kf_q.detach().cpu()
    kf_t = map_state.kf_t.detach().cpu().numpy()
    pts_out, col_out = [], []
    for k in range(0, n_kf, max(stride, 1)):
        mask = kf_mask[k]
        world = quat_rotate(kf_q[k], kf_cloud[k][mask]).numpy() + kf_t[k]
        pts_out.append(world)
        u = 0.2 + 0.8 * (k / max(n_kf - 1, 1))
        col = np.array([int(60 + 150 * u), int(220 * (1 - u) + 35),
                        int(90 + 120 * (1 - u))], np.uint8)
        col_out.append(np.tile(col, (len(world), 1)))
    if trajectory and n_kf > 0:
        traj = kf_t[:n_kf]
        # densify the polyline so it reads as a line in point viewers
        segs = [np.linspace(traj[i], traj[i + 1], 8, endpoint=False)
                for i in range(len(traj) - 1)] + [traj[-1:]]
        tp = np.concatenate(segs)
        pts_out.append(tp.astype(np.float32))
        col_out.append(np.tile(np.array([255, 40, 40], np.uint8),
                               (len(tp), 1)))
    pts = (np.concatenate(pts_out) if pts_out
           else np.zeros((0, 3), np.float32))
    cols = (np.concatenate(col_out) if col_out
            else np.zeros((0, 3), np.uint8))
    write_ply(path, pts, cols)
    return len(pts)
