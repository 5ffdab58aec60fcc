"""The work counts: the kernel table's bounds (PERF.md's table of the
port's kernels) from their shapes, and the Dense operations that
``work/network.py`` counts against the reference networks' own layers."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench.work import bounds as B
from portbench.work import network

WB = 768  # the band of 3 blocks of 256 rows at these shapes

# (kernel, bytes and operations from the timed shape, bound ms, by) as
# the table gives them, to its four decimals
ROWS = [
    ("knn_group", B.group_bytes_ops(1, 8192, 8192, 16, 99, 4, WB),
     B.PEAK_F32, 0.0168, "bytes"),
    ("knn_idw", B.idw_bytes_ops(1, 8192, 2048, 7, 132, 2,
                                network.band_width(8192, 2048, 7)),
     B.PEAK_F32, 0.0010, "bytes"),
    ("scatter_softmax_sum", B.softmax_sum_bytes_ops(1, 8192, 16, 64, 2,
                                                    8192),
     B.PEAK_F32, 0.0060, "bytes"),
    ("regroup", B.regroup_bytes_ops(1, 8192, 16, 8192, 64, 2),
     B.PEAK_F32, 0.0055, "bytes"),
    ("cost_attention", B.cost_attention_bytes_ops(8192, 16, 64, 32),
     B.PEAK_BF16, 0.0155, "bytes"),
    ("knn", B.knn_bytes_ops(1, 8192, 8192, 16, WB), B.PEAK_F32, 0.0008,
     "operations"),
    ("knn_group2", B.group2_bytes_ops(1, 8192, 8192, 16, 99, 4, WB),
     B.PEAK_F32, 0.0327, "bytes"),
    ("attention", B.attention_bytes_ops(8192, 16, 64), B.PEAK_BF16, 0.0200,
     "bytes"),
    ("scatter_add", B.scatter_bytes_ops(1, 8192, 16, 99, 4, 8192),
     B.PEAK_F32, 0.0166, "bytes"),
]


@pytest.mark.parametrize("row", ROWS, ids=[r[0] for r in ROWS])
def test_kernel_table_bounds(row):
    _, (nbytes, flops), peak, want_ms, want_by = row
    ms, by = B.bound(nbytes, flops, peak)
    assert round(ms, 4) == want_ms and by == want_by


SMALL = dict(npoint=1024, sa_npoints=(512, 256, 128, 64),
             sa_nsample=(16, 16, 16, 8),
             sa_mlps=((32, 32, 64), (64, 64, 128), (128, 128, 256),
                      (256, 256, 512)),
             cost_nsample=16, warp_nsample=(3, 5, 7, 7), upsample_k=(5, 5, 7),
             joint_seg=True, dtype="float32", neighbor_backend="banded")


def dense_flops_of(model, run) -> int:
    """2 x rows x in x out over every Dense call that ``run`` makes."""
    from portbench.reference.plain.models.layers import Dense

    total = [0]

    def hook(mod, inp, out):
        rows = inp[0].numel() // inp[0].shape[-1]
        total[0] += 2 * rows * mod.weight.shape[0] * mod.weight.shape[1]

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, Dense)]
    with torch.no_grad():
        run()
    for h in hooks:
        h.remove()
    return total[0]


def clouds(n: int):
    g = torch.Generator().manual_seed(0)
    pc = torch.rand(1, n, 3, generator=g) * 20.0
    return pc, pc + 0.1 * torch.rand(1, n, 3, generator=g)


def test_tflow_dense_count_matches_the_network():
    from portbench.reference.plain.config import FlowNetConfig
    from portbench.reference.plain.models.tflow import TFlow

    model = TFlow(FlowNetConfig(**SMALL)).eval()
    pc1, pc2 = clouds(SMALL["npoint"])
    box = (torch.amin(torch.cat([pc1, pc2], 1), 1) - 1.0,
           torch.tensor([30.0]))
    tower = dense_flops_of(model, lambda: model.tower(pc1, box))
    both = dense_flops_of(model, lambda: model.head(
        model.tower(pc1, box), model.tower(pc2, box), box))
    c = network.Counter(1, B.F32)
    network.tower(c, SMALL)
    assert c.total()["dense_flops"] == tower
    network.head(c, SMALL)
    assert c.total()["dense_flops"] == both - tower


def test_serve_count_is_one_tower_and_the_head():
    cfg = dict(flownet=dict(SMALL, dtype="bfloat16"))
    scan = network.serve_scan(cfg)
    c = network.Counter(1, B.BF16)
    network.tower(c, cfg["flownet"])
    network.head(c, cfg["flownet"])
    assert scan["model_flops"] == c.total()["model_flops"] > 0
    assert 0 < scan["bound_ms"] and np.isfinite(scan["bound_ms"])
