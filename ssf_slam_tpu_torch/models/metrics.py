"""Scene-flow and segmentation metrics (ssf_slam_tpu/models/metrics.py):
EPE3D, Acc3D strict (< 0.05 m or < 5 % relative), Acc3D relax (< 0.1 m or
< 10 %) and the outlier ratio (>= 0.3 m or >= 10 %), masked per batch row
(main_sju_occ_ros.py:112-143); seg accuracy and per-class IoU pooled over
the batch.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def flow_metrics(pred: Tensor, gt: Tensor, mask: Tensor | None = None) -> dict:
    """pred / gt [B, N, 3], mask [B, N] -> dict of scalar tensors."""
    if mask is None:
        mask = torch.ones(pred.shape[:-1], dtype=pred.dtype,
                          device=pred.device)
    mask = mask.to(pred.dtype)
    l2 = torch.linalg.norm(gt - pred, dim=-1) * mask
    sf_norm = torch.linalg.norm(gt, dim=-1) * mask
    msum = torch.clamp(torch.sum(mask, dim=1), min=1e-10)
    epe = torch.mean(torch.sum(l2, dim=1) / msum)
    rel = l2 / (sf_norm + 1e-10)

    def ratio(cond):
        return torch.mean(torch.sum(cond.to(pred.dtype) * mask, dim=1) / msum)

    return dict(epe3d=epe, acc3d_strict=ratio((l2 < 0.05) | (rel < 0.05)),
                acc3d_relax=ratio((l2 < 0.1) | (rel < 0.1)),
                outlier=ratio((l2 >= 0.3) | (rel >= 0.1)))


def seg_metrics(logits: Tensor, labels: Tensor,
                mask: Tensor | None = None) -> dict:
    """Joint-seg head quality from moving-class logits [B, N] and 0/1
    labels [B, N]: accuracy, IoU of each class and their mean, counts
    pooled over the whole batch (moving points are rare)."""
    if mask is None:
        mask = torch.ones(logits.shape, device=logits.device)
    m = mask.float()
    pred = (logits > 0.0).float()
    y = labels.float()
    acc = torch.sum((pred == y).float() * m) / torch.clamp(torch.sum(m),
                                                           min=1.0)

    def iou(p, t):
        inter = torch.sum(p * t * m)
        return inter / torch.clamp(torch.sum(torch.maximum(p, t) * m),
                                   min=1.0)

    iou_moving, iou_static = iou(pred, y), iou(1.0 - pred, 1.0 - y)
    return dict(seg_acc=acc, iou_static=iou_static, iou_moving=iou_moving,
                miou=0.5 * (iou_static + iou_moving))
