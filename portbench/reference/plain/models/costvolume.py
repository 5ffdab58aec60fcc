"""Bidirectional attentive cost volume (ssf_slam_tpu_torch/models/
costvolume.py) on its unfused branch: point-to-patch neighbourhoods in
pc2, dual-softmax cross attention, a learned softmax aggregation for the
forward cost and a scatter-softmax pushing the backward cost onto pc2."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from portbench.reference.plain.models.layers import BatchNorm, Dense, PointMLP
from portbench.reference.plain.ops.attention import cost_attention_xla
from portbench.reference.plain.ops.neighbors import (
    nn_knn_group,
    nn_regroup,
    nn_scatter_softmax_sum,
)

Tensor = torch.Tensor


class AttentiveCostVolume(nn.Module):
    """PointConvTransFlowV2 (soflow.py:281-525), channels-last.

    ``d1`` / ``d2`` are the feature widths of points1 / points2 and
    ``sf_dim`` that of the coarse-flow features (0 at the coarsest level).
    """

    def __init__(self, nsample: int, d1: int, d2: int, sf_dim: int,
                 mlp: Sequence[int], flow_mlp: Sequence[int],
                 use_flow: bool = True, out_channels: int = 3,
                 flow_clamp: float = 50.0, backend: str = "xla",
                 extent: float = 64.0):
        super().__init__()
        self.nsample, self.use_flow = nsample, use_flow
        self.flow_clamp, self.backend, self.extent = flow_clamp, backend, extent
        c = mlp[-1]
        sf = [sf_dim] if sf_dim else []
        self.mlp_q = PointMLP([d1, d2], mlp)
        self.mlp_k = PointMLP([d1, d2], mlp)
        self.mlp_cost = PointMLP([c, *sf, 3], mlp)
        # weightnet: Dense -> BN -> ReLU -> Dense -> BN -> ReLU -> Dense
        self.Dense_0 = Dense(c, c, bias=False)
        self.BatchNorm_0 = BatchNorm(c)
        self.Dense_1 = Dense(c, c // 2, bias=False)
        self.BatchNorm_1 = BatchNorm(c // 2)
        self.Dense_2 = Dense(c // 2, 1)
        self.mlp_patch = PointMLP([c, c, *sf, 3], mlp)
        self.mlp_flow = PointMLP(c, flow_mlp)
        self.fc = Dense(flow_mlp[-1], out_channels)

    def weightnet(self, x: Tensor) -> Tensor:
        x = F.relu(self.BatchNorm_0(self.Dense_0(x)))
        x = F.relu(self.BatchNorm_1(self.Dense_1(x)))
        return self.Dense_2(x)

    def forward(self, xyz1, xyz2, xyz2w, points1, points2, sf=None,
                sf_feat=None, box=None):
        k = self.nsample
        n2 = xyz2.shape[1]
        if xyz2w is None:
            xyz2w = xyz2
        query = xyz1 + sf[..., :3] if (sf is not None and self.use_flow) \
            else xyz1
        xyz2_and_feats = torch.cat([xyz2, points2.to(xyz2.dtype)], -1)

        knn_idx, grouped, plan_a, params_a = nn_knn_group(
            query, xyz2, xyz2_and_feats, k, backend=self.backend,
            extent=self.extent, box=box)
        direction_xyz = grouped[..., :3] - xyz1[..., None, :]
        q_feat = self.mlp_q([points1, grouped[..., 3:].to(points2.dtype)])

        # the reference gathers xyz2 (not xyz2w) here; xyz2w is row-aligned
        # with xyz2, so the fused gather stays valid
        knn_idxw, groupedw, plan_b, params_b = nn_knn_group(
            xyz1, xyz2w, xyz2_and_feats, k, backend=self.backend,
            extent=self.extent, box=box)
        direction_xyzw = groupedw[..., :3] - xyz1[..., None, :]
        k_feat = self.mlp_k([points1, groupedw[..., 3:].to(points2.dtype)])

        def cost_input(*feats, direction):
            parts = list(feats)
            if sf_feat is not None:
                parts.append(sf_feat)
            parts.append(direction)
            return parts

        q_cost = self.mlp_cost(cost_input(q_feat, direction=direction_xyz))
        k_cost = self.mlp_cost(cost_input(k_feat, direction=direction_xyzw))

        cost_fwd, w_k_logits = cost_attention_xla(
            q_feat, k_feat, q_cost, lambda x: self.weightnet(x)[..., 0])

        cost_bwd = nn_scatter_softmax_sum(
            k_cost, w_k_logits, knn_idxw, n2, plan_b, params_b
        ).to(k_cost.dtype)  # [B, N2, C]

        grouped_bwd = nn_regroup(cost_bwd, knn_idx, plan_a, params_a)
        g = self.mlp_patch(cost_input(cost_fwd, grouped_bwd,
                                      direction=direction_xyz))
        patch_cost = torch.amax(g, dim=-2)

        flow_feats = self.mlp_flow(patch_cost)
        re_sf = torch.clamp(self.fc(flow_feats), -self.flow_clamp,
                            self.flow_clamp)
        if sf is not None:
            re_sf = torch.clamp(re_sf + sf, -self.flow_clamp, self.flow_clamp)
        return cost_fwd, cost_bwd, flow_feats, re_sf
