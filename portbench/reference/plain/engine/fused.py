"""A drive through the network and the SLAM step, scan by scan
(ssf_slam_tpu_torch/engine/fused.py at batch 1): per scan the network on
the pair (frame k-1, frame k) under one Morton box, the static mask (the
joint head's ``out[:, 3] < 0``), then ``slam_step``. Frame 0 pairs with itself. Each
pair's two towers are computed afresh (the program caches the previous
one)."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from portbench.reference.plain.config import PipelineConfig, Variant
from portbench.reference.plain.engine.pipeline import (
    init_slam_state,
    slam_step,
    stack_outputs,
)


def sequence_box(all_points: np.ndarray, margin: float = 1.0, device="cpu"):
    """Morton box covering [..., 3] points: (origin [1, 3], scale [1])."""
    flat = np.asarray(all_points, np.float32).reshape(-1, 3)
    lo = flat.min(axis=0) - margin
    span = float((flat.max(axis=0) - lo).max()) + margin
    return (torch.as_tensor(lo[None, :], device=device),
            torch.tensor([span], dtype=torch.float32, device=device))


def anchored_box(first_points: np.ndarray, margin: float, device="cpu"):
    """The box a stream anchors at its first scan: the first scan's points
    padded by ``margin`` metres on every side."""
    pts = np.asarray(first_points, np.float32)
    return sequence_box(np.concatenate([pts - margin, pts + margin]),
                        device=device)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """float32 products in TF32 for the block (the geometry's control), or
    in true float32."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.set_float32_matmul_precision(prev[1])


def run_drive(model, frames: list, cfg: PipelineConfig, box, device,
              given: dict | None = None, tf32: bool = False) -> dict:
    """Frames (data/synthetic.py schema) -> per-scan outputs as numpy.

    Each stage is judged on its own inputs. The network's output ``flow``
    [F, N, 3 | 4] of each pair comes from the raw clouds. With ``given``
    (another run's ``flow`` [F, N, 3+] and ``static`` [F, N]) the SLAM
    step runs on the given flow and static mask, as a served model's
    reference reads the served tokens; without it, on this run's own.
    ``seg`` [F, N] is the joint head's seg logit, ``static`` [F, N] the
    mask it gives; pose_q/pose_t,
    rel_q/rel_t and is_keyframe come from the SLAM step, its float32
    products in TF32 with ``tf32``."""
    cfg = cfg.replace(variant=Variant.SSF)
    n = cfg.lidar.max_points
    state = init_slam_state(cfg, device)
    outs = []

    def tensor(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), device=device).to(dtype)

    with torch.no_grad():
        for k, f in enumerate(frames):
            p = frames[max(k - 1, 0)]
            prev = tensor(p["pos1"][:n])
            pts = tensor(f["pos1"][:n])
            flows, _ = model.head(model.tower(prev[None], box),
                                  model.tower(pts[None], box), box)
            out = flows[0][0].float()
            flow = out[:, :3] if given is None else tensor(
                given["flow"][k][:, :3])
            static = out[:, 3] < 0.0
            scan = dict(points=pts, mask=tensor(f["mask1"][:n], torch.bool),
                        time=torch.tensor(float(f["time"]), device=device),
                        flow_points=prev,
                        flow_mask=tensor(p["mask1"][:n], torch.bool),
                        flow=flow,
                        static_mask=static if given is None else tensor(
                            given["static"][k], torch.bool))
            with matmul_precision(tf32):
                state, o = slam_step(state, scan, cfg)
            o["flow"] = out
            o["static"] = static
            o["seg"] = out[:, 3]
            outs.append(o)
    return stack_outputs(outs)
