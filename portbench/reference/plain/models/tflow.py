"""TFlow: coarse-to-fine Siamese scene-flow network
(ssf_slam_tpu/models/tflow.py), split into ``tower`` (per cloud: Morton
sort, stem, SA pyramid, up-convs) and ``head`` (everything that crosses the
two clouds). ``forward`` composes them under the pair's adaptive Morton
box; the fused engine caches the previous scan's tower under a
sequence-stable box instead.

Returns per-level flows (fine first; the finest in the caller's point
order) and the FPS index chain, as the JAX module does. The Dense layers
compute in ``cfg.dtype`` over float32 masters.
"""

from __future__ import annotations

import torch
from torch import nn

from portbench.reference.plain.config import FlowNetConfig
from portbench.reference.plain.models.costvolume import AttentiveCostVolume
from portbench.reference.plain.models.layers import (
    Dense,
    PointMLP,
    SetAbstraction,
    SetUpConv,
    point_warping,
    upsample_flow,
    upsample_multi,
)
from portbench.reference.plain.ops.grouping import gather_points
from portbench.reference.plain.ops.neighbors import (
    cloud_box,
    invert_permutation,
    morton_sort,
)

Tensor = torch.Tensor


class TFlow(nn.Module):
    def __init__(self, cfg: FlowNetConfig = FlowNetConfig()):
        super().__init__()
        self.cfg = cfg
        out_ch = 4 if cfg.joint_seg else 3
        bn, be, ext = cfg.use_bn, cfg.neighbor_backend, cfg.morton_extent
        mlps = cfg.sa_mlps

        self.point_conv = PointMLP(3, (32, 32))
        in_dims = (32, mlps[0][-1], mlps[1][-1], mlps[2][-1])
        for i in range(4):
            self.add_module(f"sa{i + 1}", SetAbstraction(
                cfg.sa_npoints[i], cfg.sa_nsample[i], in_dims[i], mlps[i],
                use_bn=bn, backend=be, extent=ext))

        def su(level, sparse_dim, dense_dim, widths):
            return SetUpConv(min(16, cfg.sa_npoints[level]), sparse_dim,
                             dense_dim, widths, widths, use_bn=bn,
                             backend=be, extent=ext)

        self.su3 = su(3, mlps[3][-1], mlps[2][-1], (256, 256))
        self.su2 = su(2, 256, mlps[1][-1], (128, 128))
        self.su1 = su(1, 128, mlps[0][-1], (64, 64))
        self.su0 = su(0, 64, 32, (64, 64))

        def cost(d, sf_dim, mlp, flow_mlp, use_flow):
            return AttentiveCostVolume(
                cfg.cost_nsample, d, d, sf_dim, mlp, flow_mlp,
                use_flow=use_flow, out_channels=out_ch,
                flow_clamp=cfg.flow_clamp, backend=be, extent=ext)

        # points1/points2 widths: up-conv features || deconv'd cost features
        self.flow3_r = cost(256, 0, (256, 256), (128, 128), False)
        self.flow2_r = cost(128 + 64, 128, (128, 128), (128, 128), True)
        self.flow1_r = cost(64 + 32, 128, (64, 64), (64, 64), True)
        self.flow0_r = cost(64 + 32, 64, (64, 64), (64, 64), True)

        self.deconv3_2 = PointMLP(256, (64,))
        self.deconv2_1 = PointMLP(128, (32,))
        self.deconv1_0 = PointMLP(64, (32,))

        dtype = getattr(torch, cfg.dtype)
        for m in self.modules():
            if isinstance(m, Dense):
                m.dtype = dtype

    def tower(self, pc: Tensor, box=None) -> dict:
        """Per-cloud half. On the banded backend ``box`` must be the Morton
        box both towers of a pair share."""
        perm = None
        if self.cfg.neighbor_backend == "banded":
            pc, perm = morton_sort(pc, box=box)
        feats = self.point_conv(pc)
        l1_pc, l1_f, l1_idx = self.sa1(pc, feats, box=box)
        l2_pc, l2_f, l2_idx = self.sa2(l1_pc, l1_f, box=box)
        l3_pc, l3_f, l3_idx = self.sa3(l2_pc, l2_f, box=box)
        l4_pc, l4_f, _ = self.sa4(l3_pc, l3_f, box=box)

        l3_4_f = self.su3(l3_pc, l4_pc, l3_f, l4_f, box=box)
        l2_3_f = self.su2(l2_pc, l3_pc, l2_f, l3_4_f, box=box)
        l1_2_f = self.su1(l1_pc, l2_pc, l1_f, l2_3_f, box=box)
        l0_f = self.su0(pc, l1_pc, feats, l1_2_f, box=box)
        return dict(pc=pc, perm=perm, l1_pc=l1_pc, l2_pc=l2_pc, l3_pc=l3_pc,
                    l3_4_f=l3_4_f, l2_3_f=l2_3_f, l1_2_f=l1_2_f, l0_f=l0_f,
                    l1_idx=l1_idx, l2_idx=l2_idx, l3_idx=l3_idx)

    def head(self, t1: dict, t2: dict, box=None):
        """Cross-cloud half: per-level cost volumes, warping, upsampling."""
        cfg = self.cfg
        kw = dict(backend=cfg.neighbor_backend, extent=cfg.morton_extent,
                  box=box)
        uk, wn, uc = cfg.upsample_k, cfg.warp_nsample, cfg.upsample_clamp
        pc1, pc2 = t1["pc"], t2["pc"]

        c_fwd_l3, c_bwd_l3, l3_feats, l3_flow = self.flow3_r(
            t1["l3_pc"], t2["l3_pc"], None, t1["l3_4_f"], t2["l3_4_f"],
            box=box)

        def level(lv, t_key, sparse_key, deconv, flow_r, prev, dense1=None,
                  dense2=None):
            """One refinement level: upsample the coarser level's flow, flow
            features and forward cost; upsample its backward cost; warp;
            run the cost volume."""
            flow, feats, c_fwd_prev, c_bwd_prev = prev
            p1 = t1[f"l{lv}_pc"] if dense1 is None else dense1
            p2 = t2[f"l{lv}_pc"] if dense2 is None else dense2
            coarse, sf_feat, c_fwd_up = upsample_multi(
                p1, t1[sparse_key], (flow, feats, c_fwd_prev),
                k=uk[2 - lv], clamp=uc, **kw)
            c_fwd = torch.cat([t1[t_key], deconv(c_fwd_up)], dim=-1)
            c_bwd = torch.cat([t2[t_key], deconv(upsample_flow(
                p2, t2[sparse_key], c_bwd_prev, clamp=uc, **kw))], dim=-1)
            pc2w = point_warping(p1, p2, coarse, wn[3 - lv],
                                 clamp=cfg.warp_clamp, **kw)
            c_fwd_n, c_bwd_n, feats_n, flow_n = flow_r(
                p1, p2, pc2w, c_fwd, c_bwd, coarse, sf_feat, box=box)
            return flow_n, feats_n, c_fwd_n, c_bwd_n

        l2 = level(2, "l2_3_f", "l3_pc", self.deconv3_2, self.flow2_r,
                   (l3_flow, l3_feats, c_fwd_l3, c_bwd_l3))
        l1 = level(1, "l1_2_f", "l2_pc", self.deconv2_1, self.flow1_r, l2)
        flow, _, _, _ = level(0, "l0_f", "l1_pc", self.deconv1_0,
                              self.flow0_r, l1, dense1=pc1, dense2=pc2)

        l1_idx = t1["l1_idx"]
        if t1["perm"] is not None:
            # finest flow back to the caller's point order; coarser levels
            # ride the composed FPS index chain
            inv = invert_permutation(t1["perm"])
            flow = torch.gather(flow, 1,
                                inv[..., None].expand(-1, -1, flow.shape[-1]))
            l1_idx = torch.gather(t1["perm"], 1, l1_idx)
        flows = [flow, l1[0], l2[0], l3_flow]  # fine -> coarse
        return flows, [l1_idx, t1["l2_idx"], t1["l3_idx"]]

    def forward(self, pc1: Tensor, pc2: Tensor, box=None):
        if box is None and self.cfg.neighbor_backend == "banded":
            box = cloud_box(pc1, pc2)
        return self.head(self.tower(pc1, box), self.tower(pc2, box), box)

