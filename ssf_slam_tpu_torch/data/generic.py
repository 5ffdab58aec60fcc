"""Generic scene-flow readers: the port's copy of
``ssf_slam_tpu/data/generic.py`` (numpy only).

The benchmark loader family the reference selects with --dataset /
--dataset_cls (main_sju_occ_ros.py:613-666):
- HPLFlowNet layout (FT3D subset, KITTI142): per-example directories with
  index-aligned pc1.npy / pc2.npy, flow = pc2 - pc1;
- FlowNet3D layout: one npz per example with explicit flow (keys
  points1/points2/flow[/valid_mask1] or pos1/pos2/gt[/s_fg_mask]).
Every reader emits the canonical frame dict (pos1/pos2/gt/s_fg_mask/mask1,
padded to n_points); ``make_dataset`` is the CLI's ``--dataset-kind``.
"""

from __future__ import annotations

import abc
import glob
import os

import numpy as np

from ssf_slam_tpu_torch.data.carla import pad_points


class SceneFlowDataset(abc.ABC):
    """Abstract base: subclasses implement raw loading; padding is shared."""

    def __init__(self, n_points: int = 8192, seed: int = 0):
        self.n_points = n_points
        self.rng = np.random.default_rng(seed)

    @abc.abstractmethod
    def __len__(self) -> int: ...

    @abc.abstractmethod
    def load_raw(self, i: int) -> dict:
        """Return {pos1, pos2, gt[, mask1, s_fg_mask]} unpadded."""

    def __getitem__(self, i: int) -> dict:
        raw = self.load_raw(i)
        n = self.n_points
        keep = raw.get("mask1")
        pos1 = raw["pos1"] if keep is None else raw["pos1"][keep.astype(bool)]
        gt = raw["gt"] if keep is None else raw["gt"][keep.astype(bool)]
        fg = raw.get("s_fg_mask", np.zeros(len(raw["pos1"]), np.float32))
        fg = fg if keep is None else fg[keep.astype(bool)]
        p1, m1, i1 = pad_points(pos1, n, self.rng)
        p2, m2, _ = pad_points(raw["pos2"], n, self.rng)
        return dict(
            pos1=p1, pos2=p2, gt=gt[i1].astype(np.float32),
            ego_flow=np.zeros((n, 3), np.float32),
            s_fg_mask=fg[i1].astype(np.float32) * m1,
            t_fg_mask=np.zeros(n, np.float32),
            mask1=m1, mask2=m2, time=float(i) * 0.1,
        )


class HplflownetDataset(SceneFlowDataset):
    """HPLFlowNet-preprocessed layout: per-example dir with pc1.npy/pc2.npy
    (index-aligned; flow = pc2 - pc1). Covers both FT3D-subset and KITTI142.
    """

    def __init__(self, root: str, **kw):
        super().__init__(**kw)
        self.dirs = sorted(
            d for d in glob.glob(os.path.join(root, "*"))
            if os.path.isdir(d) and os.path.exists(os.path.join(d, "pc1.npy"))
        )
        if not self.dirs:
            raise FileNotFoundError(f"no pc1.npy example dirs under {root}")

    def __len__(self):
        return len(self.dirs)

    def load_raw(self, i: int) -> dict:
        d = self.dirs[i]
        pc1 = np.load(os.path.join(d, "pc1.npy")).astype(np.float32)
        pc2 = np.load(os.path.join(d, "pc2.npy")).astype(np.float32)
        return dict(pos1=pc1, pos2=pc2, gt=pc2 - pc1)


class Flownet3dDataset(SceneFlowDataset):
    """FlowNet3D-preprocessed layout: one npz per example with explicit flow
    and optional occlusion mask. Accepts both key dialects
    (points1/points2/flow[/valid_mask1] and pos1/pos2/gt[/s_fg_mask])."""

    def __init__(self, root: str, **kw):
        super().__init__(**kw)
        self.paths = sorted(
            glob.glob(os.path.join(root, "**", "*.npz"), recursive=True)
        )
        if not self.paths:
            raise FileNotFoundError(f"no npz examples under {root}")

    def __len__(self):
        return len(self.paths)

    def load_raw(self, i: int) -> dict:
        with np.load(self.paths[i]) as z:
            keys = set(z.files)
            if "points1" in keys:
                out = dict(
                    pos1=z["points1"].astype(np.float32),
                    pos2=z["points2"].astype(np.float32),
                    gt=z["flow"].astype(np.float32),
                )
                if "valid_mask1" in keys:
                    out["mask1"] = z["valid_mask1"]
                if "s_fg_mask" in keys:
                    # optional GT moving-object labels riding along with the
                    # FN3D keys (the reference's own CARLA npz carries the
                    # same mask next to its flow; scripts/make_town02_seq.py
                    # writes it for mover sequences)
                    out["s_fg_mask"] = z["s_fg_mask"].astype(np.float32)
                return out
            out = dict(
                pos1=z["pos1"].astype(np.float32),
                pos2=z["pos2"].astype(np.float32),
                gt=z["gt"].astype(np.float32),
            )
            if "s_fg_mask" in keys:
                out["s_fg_mask"] = z["s_fg_mask"].astype(np.float32)
            return out


DATASET_REGISTRY = {
    "carla": "ssf_slam_tpu_torch.data.carla.CarlaSceneFlowDataset",
    "ft3d_hpl": HplflownetDataset,
    "kitti_hpl": HplflownetDataset,
    "ft3d_fn3d": Flownet3dDataset,
    "kitti_fn3d": Flownet3dDataset,
}


def make_dataset(kind: str, root: str, **kw):
    """Dataset factory (the --dataset_cls switch equivalent)."""
    if kind == "carla":
        from ssf_slam_tpu_torch.data.carla import CarlaSceneFlowDataset

        return CarlaSceneFlowDataset(root, **kw)
    cls = DATASET_REGISTRY[kind]
    return cls(root, **kw)
