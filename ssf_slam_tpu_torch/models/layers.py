"""PointNet++-style building blocks, channels-last
(ssf_slam_tpu/models/layers.py).

Module and parameter names follow the Flax tree (``Dense_0_part1``,
``BatchNorm_2``, ``PointMLP_0``) so that ``weights.from_flax`` is a
mechanical rename: a Flax leaf ``a/b/Dense_0/kernel`` is the torch tensor
``a.b.Dense_0.weight`` transposed.

The layers follow Flax's policy: parameters are float32 masters and the
Dense products run in the compute type (``Dense.dtype``); BatchNorm
computes in float32. In train mode (``module.train()``) BatchNorm
normalises with the batch's statistics and updates its running ones, as
``flax.linen.BatchNorm(momentum=0.9, epsilon=1e-3)`` does; ``init_flax``
draws Flax's initial values.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ssf_slam_tpu_torch.ops.fps import farthest_point_sample
from ssf_slam_tpu_torch.ops.grouping import gather_points
from ssf_slam_tpu_torch.ops.neighbors import nn_knn_group, nn_knn_idw

Tensor = torch.Tensor

LEAKY_RATE = 0.1


class Dense(nn.Module):
    """flax.linen.Dense(dtype, param_dtype=float32): y = x W + b with the
    input, the weight and the bias rounded to the compute type ``dtype``
    (float32 masters, as Flax's ``promote_dtype`` casts them). The weight
    is stored [out, in] (PyTorch's layout); ``weights.from_flax`` transposes
    the Flax kernel [in, out]. Without autograd the compute-type copies are
    kept until the masters change, so serving pays no cast per call."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(out_features, in_features))
        self.bias = (nn.Parameter(torch.zeros(out_features)) if bias
                     else None)
        self._cast_cache: dict = {}

    def _cast(self, name: str, t: Tensor | None) -> Tensor | None:
        if t is None or t.dtype == self.dtype:
            return t
        if torch.is_grad_enabled():
            return t.to(self.dtype)
        key = (t.device, t.data_ptr(), t._version)
        hit = self._cast_cache.get(name)
        if hit is None or hit[0] != key:
            hit = (key, t.detach().to(self.dtype))
            self._cast_cache[name] = hit
        return hit[1]

    def forward(self, x: Tensor) -> Tensor:
        return F.linear(x.to(self.dtype), self._cast("weight", self.weight),
                        self._cast("bias", self.bias))


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm(momentum=0.9, epsilon=1e-3), computed in
    float32 in Flax's op order ((x - mean) * (rsqrt(var + eps) * scale) +
    bias) and returned in the input's type.

    Eval mode normalises with the running statistics. Train mode takes the
    batch's over every axis but the last (padded points included): the
    mean and the biased variance E[x^2] - E[x]^2 clamped at 0, and updates
    the running statistics to 0.9 old + 0.1 batch. (PyTorch's batch_norm
    would update running_var with the unbiased variance.) With ``group``
    set (a ``torch.distributed`` process group, as
    ``parallel/mesh.py::make_sharded_train_step`` sets it) the batch is
    the one sharded over the group: the sums of x and x^2 and the counts
    are all-reduced, with gradients flowing through the reduction, as the
    JAX step's GSPMD computes the statistics of the global batch."""

    momentum = 0.9

    def __init__(self, features: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.group = None

    def _global_moments(self, x32: Tensor, axes: tuple) -> tuple:
        """E[x] and E[x^2] over the batch sharded across ``group``."""
        import warnings

        from torch.distributed.nn.functional import all_reduce

        count = x32.new_full((1,), float(x32.numel() // x32.shape[-1]))
        with warnings.catch_warnings():
            # newer PyTorch marks the module deprecated; its all_reduce
            # carries the gradient the step needs
            warnings.simplefilter("ignore", FutureWarning)
            sums = all_reduce(torch.cat([torch.sum(x32, dim=axes),
                                         torch.sum(x32 * x32, dim=axes),
                                         count]), group=self.group)
        c = x32.shape[-1]
        return sums[:c] / sums[-1], sums[c:2 * c] / sums[-1]

    def forward(self, x: Tensor) -> Tensor:
        x32 = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            if self.group is None:
                mean = torch.mean(x32, dim=axes)
                mean2 = torch.mean(x32 * x32, dim=axes)
            else:
                mean, mean2 = self._global_moments(x32, axes)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean) * mul + self.bias
        return y.to(x.dtype)


def init_flax(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Flax's initial values in place: Dense kernels ``lecun_normal``
    (a normal of std sqrt(1 / fan_in) truncated at two std, rescaled to
    keep that std), Dense biases 0, BatchNorm scale 1 and bias 0, running
    mean 0 and variance 1. Modules are visited in registration order."""
    std_of_unit_trunc = 0.87962566103423978  # std of N(0, 1) cut at +-2
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Dense):
                std = (1.0 / m.weight.shape[1]) ** 0.5 / std_of_unit_trunc
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std,
                                      2.0 * std, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, BatchNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model


class PointMLP(nn.Module):
    """Stack of pointwise Dense(+BN)+activation layers.

    ``in_dims`` is one width, or a list of part widths: then the first layer
    is one Dense per part (``Dense_0_part{j}``), bias on part 0 only and
    only without BN, and the parts' outputs are summed — lower-rank parts
    (per-point features against [.., K, C] neighbour tensors) broadcast
    over K. ReLU when ``leaky`` is False (SA, SetUpConv), leaky 0.1 else.
    """

    def __init__(self, in_dims: int | Sequence[int], features: Sequence[int],
                 use_bn: bool = False, leaky: bool = True):
        super().__init__()
        self.features = tuple(features)
        self.use_bn, self.leaky = use_bn, leaky
        self.n_parts = 0 if isinstance(in_dims, int) else len(in_dims)
        width = in_dims
        for i, f in enumerate(self.features):
            if i == 0 and self.n_parts:
                for j, c in enumerate(in_dims):
                    self.add_module(f"Dense_0_part{j}",
                                    Dense(c, f, bias=not use_bn and j == 0))
            else:
                self.add_module(f"Dense_{i}", Dense(width, f,
                                                    bias=not use_bn))
            if use_bn:
                self.add_module(f"BatchNorm_{i}", BatchNorm(f))
            width = f

    def forward(self, x) -> Tensor:
        for i in range(len(self.features)):
            if i == 0 and self.n_parts:
                if len(x) != self.n_parts:
                    raise ValueError(f"expected {self.n_parts} parts")
                rank = max(p.dim() for p in x)
                y = None
                for j, p in enumerate(x):
                    d = getattr(self, f"Dense_0_part{j}")(p)
                    while d.dim() < rank:
                        d = d[..., None, :]
                    y = d if y is None else y + d
                x = y
            else:
                x = getattr(self, f"Dense_{i}")(x)
            if self.use_bn:
                x = getattr(self, f"BatchNorm_{i}")(x)
            x = F.leaky_relu(x, LEAKY_RATE) if self.leaky else F.relu(x)
        return x


class SetAbstraction(nn.Module):
    """FPS -> kNN group -> [dxyz || feats] -> MLP -> max-pool."""

    def __init__(self, npoint: int, nsample: int, in_dim: int,
                 mlp: Sequence[int], use_bn: bool = True,
                 backend: str = "xla", extent: float = 64.0):
        super().__init__()
        self.npoint, self.nsample = npoint, nsample
        self.backend, self.extent = backend, extent
        self.PointMLP_0 = PointMLP([3, in_dim], mlp, use_bn=use_bn,
                                   leaky=False)

    def forward(self, xyz: Tensor, feats: Tensor, box=None):
        fps_idx = farthest_point_sample(xyz, self.npoint)
        # ascending order keeps a subset of a Morton-sorted cloud sorted
        fps_idx = torch.sort(fps_idx, dim=-1).values
        new_xyz = gather_points(xyz, fps_idx)
        _, grouped, _, _ = nn_knn_group(
            new_xyz, xyz, torch.cat([xyz, feats.to(xyz.dtype)], -1),
            self.nsample, backend=self.backend, extent=self.extent, box=box)
        pos_diff = grouped[..., :3] - new_xyz[..., None, :]
        x = self.PointMLP_0([pos_diff, grouped[..., 3:]])
        return new_xyz, torch.amax(x, dim=-2), fps_idx


class SetUpConv(nn.Module):
    """Feature propagation sparse -> dense with a skip connection."""

    def __init__(self, nsample: int, sparse_dim: int, dense_dim: int,
                 mlp: Sequence[int], mlp2: Sequence[int], use_bn: bool = True,
                 backend: str = "xla", extent: float = 64.0):
        super().__init__()
        self.nsample, self.backend, self.extent = nsample, backend, extent
        self.PointMLP_0 = PointMLP([sparse_dim, 3], mlp, use_bn=use_bn,
                                   leaky=False)
        self.PointMLP_1 = PointMLP(mlp[-1] + dense_dim, mlp2, use_bn=use_bn,
                                   leaky=False)

    def forward(self, dense_xyz: Tensor, sparse_xyz: Tensor,
                dense_feats: Tensor, sparse_feats: Tensor, box=None):
        _, grouped, _, _ = nn_knn_group(
            dense_xyz, sparse_xyz,
            torch.cat([sparse_xyz, sparse_feats.to(sparse_xyz.dtype)], -1),
            self.nsample, backend=self.backend, extent=self.extent, box=box)
        pos_diff = grouped[..., :3] - dense_xyz[..., None, :]
        x = self.PointMLP_0([grouped[..., 3:], pos_diff])
        x = torch.amax(x, dim=-2)
        x = torch.cat([x, dense_feats], dim=-1)
        return self.PointMLP_1(x)


def upsample_flow(dense_xyz, sparse_xyz, sparse_flow, k: int = 3,
                  clamp: float = 100.0, backend: str = "xla",
                  extent: float = 64.0, box=None) -> Tensor:
    """Inverse-distance kNN upsampling (soflow.py:1442-1475)."""
    out = nn_knn_idw(dense_xyz, sparse_xyz, sparse_flow, k,
                     backend=backend, extent=extent, box=box)
    return torch.clamp(out, -clamp, clamp)


def upsample_multi(dense_xyz, sparse_xyz, fields, k: int = 3,
                   clamp: float = 100.0, backend: str = "xla",
                   extent: float = 64.0, box=None) -> list:
    """Upsample several co-located fields with one kNN and one gather."""
    cat = torch.cat(list(fields), dim=-1)
    out = torch.clamp(nn_knn_idw(dense_xyz, sparse_xyz, cat, k,
                                 backend=backend, extent=extent, box=box),
                      -clamp, clamp)
    return list(torch.split(out, [f.shape[-1] for f in fields], dim=-1))


def point_warping(pos1, pos2, flow1, nsample: int = 3, clamp: float = 10.0,
                  backend: str = "xla", extent: float = 64.0,
                  box=None) -> Tensor:
    """Warp pos2 backward by the flow interpolated at pos2
    (soflow.py:1222-1257); pos1 + flow is only near-Morton-sorted, which
    the band plan tolerates."""
    if flow1 is None:
        return pos2
    pos1_to_2 = pos1 + flow1[..., :3]
    flow2 = nn_knn_idw(pos2, pos1_to_2, flow1, nsample, backend=backend,
                       extent=extent, box=box)
    return torch.clamp(pos2 - flow2[..., :3], -clamp, clamp)
