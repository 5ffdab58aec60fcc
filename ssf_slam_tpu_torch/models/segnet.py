"""Static/moving point segmentation network (ssf_slam_tpu/models/segnet.py).

The ssfc variant's classifier: a PointNet++ semantic-segmentation net fed
[xyz || flow] per point, whose argmax (class 0 = static) gates the
ego-motion (main_sju_occ_addSeg_Pointnet2_ros.py:360-378). ``n_sa_levels=0``
is the 6-layer per-point MLP classifier of
ActiveSceneFlow_Classification.py:245-277.

On the banded backend the net builds its own Morton box over the cloud it
is given (``cloud_box``, not the fused step's sequence box), Morton-sorts
the cloud and its features, and puts the logits back into input order.
Module names follow the Flax tree (``stem``, ``sa1``, ``fp1``, ``head``,
``Dense_0``), so ``weights.from_flax`` loads a SegNet checkpoint as it
loads TFlow's.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ssf_slam_tpu_torch.models.layers import (
    Dense,
    PointMLP,
    SetAbstraction,
    SetUpConv,
)
from ssf_slam_tpu_torch.ops.neighbors import (
    cloud_box,
    invert_permutation,
    morton_sort,
)

Tensor = torch.Tensor


class SegNet(nn.Module):
    """PointNet++ sem-seg: [B, N, 3] xyz + [B, N, C] feats ->
    [B, N, n_classes] logits, the Dense layers computing in ``dtype``."""

    def __init__(self, n_classes: int = 2, in_feats: int = 3,
                 sa_npoints: Sequence[int] = (1024, 256),
                 sa_nsample: Sequence[int] = (16, 16),
                 sa_mlps: Sequence[Sequence[int]] = ((32, 32, 64),
                                                     (64, 64, 128)),
                 head: Sequence[int] = (128, 64), n_sa_levels: int = 2,
                 dtype: str | torch.dtype = "float32",
                 neighbor_backend: str = "xla",
                 morton_extent: float = 64.0):
        super().__init__()
        self.n_sa_levels = n_sa_levels
        self.neighbor_backend = neighbor_backend
        be, ext = neighbor_backend, morton_extent
        if n_sa_levels == 0:
            self.PointMLP_0 = PointMLP(in_feats, head, use_bn=True,
                                       leaky=False)
        else:
            self.stem = PointMLP(3 + in_feats, (32,), use_bn=True,
                                 leaky=False)
            widths = [32]
            for i in range(n_sa_levels):
                self.add_module(f"sa{i + 1}", SetAbstraction(
                    sa_npoints[i], sa_nsample[i], widths[-1], sa_mlps[i],
                    backend=be, extent=ext))
                widths.append(sa_mlps[i][-1])
            x_dim = widths[-1]
            for i in reversed(range(n_sa_levels)):
                w = sa_mlps[i][-1]
                self.add_module(f"fp{i + 1}", SetUpConv(
                    8, x_dim, widths[i], (w,), (w,), backend=be, extent=ext))
                x_dim = w
            self.head = PointMLP(x_dim, head, use_bn=True, leaky=False)
        self.Dense_0 = Dense(head[-1], n_classes)
        dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
        for m in self.modules():
            if isinstance(m, Dense):
                m.dtype = dtype

    def forward(self, xyz: Tensor, feats: Tensor) -> Tensor:
        if self.n_sa_levels == 0:
            return self.Dense_0(self.PointMLP_0(feats))
        perm = box = None
        if self.neighbor_backend == "banded":
            box = cloud_box(xyz)
            xyz, perm = morton_sort(xyz, box=box)
            feats = torch.gather(
                feats, -2, perm[..., None].expand(-1, -1, feats.shape[-1]))
        x = self.stem(torch.cat([xyz, feats], -1))
        xyzs, skips = [xyz], [x]
        for i in range(self.n_sa_levels):
            sxyz, x, _ = getattr(self, f"sa{i + 1}")(xyzs[-1], x, box=box)
            xyzs.append(sxyz)
            skips.append(x)
        for i in reversed(range(self.n_sa_levels)):
            x = getattr(self, f"fp{i + 1}")(xyzs[i], xyzs[i + 1], skips[i],
                                            x, box=box)
        logits = self.Dense_0(self.head(x))
        if perm is not None:
            inv = invert_permutation(perm)
            logits = torch.gather(
                logits, -2, inv[..., None].expand(-1, -1, logits.shape[-1]))
        return logits
