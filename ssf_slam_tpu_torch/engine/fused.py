"""The fused network-in-the-loop step of the SSF and SF variants
(ssf_slam_tpu/engine/fused.py).

Per scan: the current cloud's TFlow tower, the head against the cached
tower of the previous scan, then the whole SLAM step (``engine/pipeline.py::
slam_step``) on the previous cloud and its flow: plane features, the
ego-motion (SSF: IRLS Kabsch under the joint seg head's static mask,
``out[:, 3] < 0``, or with ``seg_apply`` (ssfc) under the separate
classifier's ``argmax == 0`` over [xyz || flow]; SF: a GMM split of
[flow || xyz], the seg channel of a joint model unused), odometry
integration and the seg-gated keyframe mapping back end.

Tower caching: frame k's cloud-1 is frame k-1's cloud-2, so the previous
scan's tower rides the carry ``(SlamStates, tower_prev)``. A cached tower is
valid only under a sequence-stable Morton box (``sequence_box``).

The step takes a batch of B sequences (B = 1 for one): the network runs
once a scan over the batch, the SLAM step for each member with its own
state (``parallel/mesh.py::run_sequences_fused_batched``, the port's
counterpart of scripts/batch_economics.py's ``vmap`` of the step).

Under a profiler (``utils/logging.py::span``) a scan's step is the range
``ssf.step`` (its index as the argument ``scan``), opened by the caller, with
``ssf.tower``, ``ssf.head`` and one ``ssf.slam_step`` a member inside it.
"""

from __future__ import annotations

import numpy as np
import torch

from ssf_slam_tpu_torch.config import PipelineConfig, Variant
from ssf_slam_tpu_torch.device import resolve_device
from ssf_slam_tpu_torch.engine.pipeline import (
    init_slam_state,
    slam_step,
    stack_outputs,
)
from ssf_slam_tpu_torch.ops.precision import set_geom_precision
from ssf_slam_tpu_torch.utils.logging import span

Tensor = torch.Tensor


def sequence_box(all_points: np.ndarray, margin: float = 1.0,
                 device: str | torch.device = "cpu"):
    """Morton box covering a whole sequence ([..., 3] points): (origin
    [1, 3], scale [1]) float32, computed as the JAX package does."""
    flat = np.asarray(all_points, np.float32).reshape(-1, 3)
    lo = flat.min(axis=0) - margin
    span = float((flat.max(axis=0) - lo).max()) + margin
    return (torch.as_tensor(lo[None, :], device=device),
            torch.tensor([span], dtype=torch.float32, device=device))


def stack_fused_scans(frames: list, n: int) -> dict:
    """Frame dicts -> the step's stacked numpy scan arrays; frame k's
    "prev" is frame k-1 (frame 0 pairs with itself)."""
    prev = [frames[max(k - 1, 0)] for k in range(len(frames))]
    return dict(
        points=np.stack([f["pos1"][:n] for f in frames]).astype(np.float32),
        prev=np.stack([f["pos1"][:n] for f in prev]).astype(np.float32),
        mask=np.stack([f["mask1"][:n].astype(bool) for f in frames]),
        prev_mask=np.stack([f["mask1"][:n].astype(bool) for f in prev]),
        time=np.asarray([f["time"] for f in frames], np.float32),
    )


def slam_scan_of(scan: dict, out: Tensor, use_gmm: bool = False,
                 seg_apply=None) -> dict:
    """The SLAM step's scan dict of one fused scan {points, prev, mask,
    prev_mask, time} and its network output ``out`` [N, 3 | 4]: the flow
    of the pair (prev -> points) and, for SSF, the static mask (the joint
    head's ``out[:, 3] < 0``, or ``seg_apply``'s ``argmax == 0``)."""
    slam_scan = dict(points=scan["points"], mask=scan["mask"],
                     time=scan["time"], flow_points=scan["prev"],
                     flow_mask=scan["prev_mask"], flow=out[:, :3].float())
    if not use_gmm and seg_apply is not None:
        logits = seg_apply(scan["prev"][None], slam_scan["flow"][None])
        slam_scan["static_mask"] = torch.argmax(logits[0], -1) == 0
    elif not use_gmm:
        slam_scan["static_mask"] = out[:, 3] < 0.0
    return slam_scan


def make_fused_step(model, cfg: PipelineConfig, box, use_gmm: bool = False,
                    seg_apply=None):
    """The step of SF (``use_gmm``) or SSF over a batch of B sequences
    (B = 1 for one sequence): the variant of ``cfg`` is set to that. Per
    scan the network runs once over the batch (the tower of the B current
    clouds, the head against the B cached towers), then the SLAM step for
    each member on its own ``SlamState``. ``seg_apply(pc [1, N, 3], flow
    [1, N, 3]) -> logits [1, N, 2]`` (ssfc, e.g. a ``SegNet``) makes SSF's
    static mask the classifier's ``argmax == 0`` (a tie goes to class 0,
    static) instead of the joint head's; the head's fourth channel is then
    unused. Returns ``(step, make_carry)``:
    - ``step(carry, scan) -> (carry, outputs)`` for one scan dict of
      tensors {points [B, N, 3], prev [B, N, 3], mask [B, N], prev_mask
      [B, N], time [B]} with ``carry = (list of B SlamState, tower of the
      B previous clouds)``; outputs is a list of B ``slam_step`` output
      dicts, each with the member's network output ``flow`` [N, 3 | 4];
    - ``make_carry(first_prev [B, N, 3]) -> carry`` with the initial
      states and tower (frame 0 pairs with itself).
    On the banded backend every member's clouds must lie in ``box``.
    """
    cfg = cfg.replace(variant=Variant.SF if use_gmm else Variant.SSF)
    if model.cfg.neighbor_backend == "banded" and box is None:
        raise ValueError("tower caching on the banded backend needs a "
                         "sequence-stable Morton box (sequence_box)")

    def step(carry, scan: dict):
        states, tower_prev = carry
        with span("tower"):
            t_curr = model.tower(scan["points"], box)
        with span("head"):
            flows, _ = model.head(tower_prev, t_curr, box)
        out = flows[0]
        new_states, outputs = [], []
        for b, state in enumerate(states):
            member = {k: v[b] for k, v in scan.items()}
            slam_scan = slam_scan_of(member, out[b], use_gmm, seg_apply)
            with span("slam_step"):
                state, o = slam_step(state, slam_scan, cfg)
            o["flow"] = out[b]
            new_states.append(state)
            outputs.append(o)
        return (new_states, t_curr), outputs

    def make_carry(first_prev):
        states = [init_slam_state(cfg, first_prev.device)
                  for _ in range(len(first_prev))]
        with span("tower"):
            return states, model.tower(first_prev, box)

    return step, make_carry


def run_fused_members(model, frames_batch: list, cfg: PipelineConfig,
                      device: str | torch.device = "cuda", box=None,
                      use_gmm: bool = False, seg_apply=None):
    """B sequences of equal length (lists of frame dicts) through one
    fused step at batch B: (list of B final SlamStates, list of B output
    dicts as numpy [S, ...]). ``box`` defaults to the ``sequence_box`` of
    all the frames; ``model`` must already live on ``device``."""
    dev = resolve_device(device)
    if next(model.parameters()).device.type != dev.type:
        raise ValueError(f"model is not on {dev}")
    set_geom_precision()
    members = [stack_fused_scans(f, cfg.lidar.max_points)
               for f in frames_batch]
    lengths = {len(m["time"]) for m in members}
    if len(lengths) != 1:
        raise ValueError(f"sequences of unequal length {sorted(lengths)}")
    arrays = {k: np.stack([m[k] for m in members]) for k in members[0]}
    if box is None and model.cfg.neighbor_backend == "banded":
        box = sequence_box(arrays["points"], device=dev)
    scans = {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}
    step, make_carry = make_fused_step(model, cfg, box, use_gmm, seg_apply)
    outs = []
    with torch.inference_mode():
        carry = make_carry(scans["prev"][:, 0])
        for k in range(scans["points"].shape[1]):
            with span("step", scan=k):
                carry, o = step(carry, {key: v[:, k] for key, v in
                                        scans.items()})
            outs.append(o)
    return carry[0], [stack_outputs([o[b] for o in outs])
                      for b in range(len(frames_batch))]


def run_sequence_fused(model, frames: list,
                       cfg: PipelineConfig = PipelineConfig(),
                       device: str | torch.device = "cuda",
                       box=None, use_gmm: bool = False,
                       seg_apply=None, return_state: bool = False):
    """Frames (data/synthetic.py schema) -> per-frame outputs as numpy:
    the map pose pose_q [F, 4] / pose_t [F, 3], odom_q / odom_t, rel_q /
    rel_t, is_keyframe [F] bool, n_features and n_dyn_over [F] int32, and
    the network output flow [F, N, 3 | 4] (flow + seg logit of the pair
    (frame k-1, frame k), in frame k-1's point order). The variant is SF
    with ``use_gmm``, else SSF (ssfc with ``seg_apply``, see
    ``make_fused_step``), whatever ``cfg`` says. ``model`` must
    already live on ``device``. ``box`` defaults to the ``sequence_box`` of
    the frames; pass a longer sequence's box to run a prefix of it. With
    ``return_state`` it returns (final SlamState, outputs), as the JAX
    package's function does."""
    states, outs = run_fused_members(model, [frames], cfg, device, box,
                                     use_gmm, seg_apply)
    if return_state:
        return states[0], outs[0]
    return outs[0]
