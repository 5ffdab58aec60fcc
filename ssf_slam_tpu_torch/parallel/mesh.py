"""Many sequences on one card (ssf_slam_tpu/parallel/mesh.py).

The JAX package runs B sequences through one step with ``vmap``
(``run_sequences_batched``) and measures the fused SSF step under ``vmap``
in scripts/batch_economics.py. There is one card here, so nothing is
sharded:

- ``run_sequences_batched``: B sequences of equal length through
  ``slam_step`` on the flow the frames provide (any variant but ssfc),
  each member by ``engine/pipeline.py::run_sequence_scan``;
- ``run_sequences_fused_batched``: ``engine/fused.py::make_fused_step``
  over B sequences under ONE Morton box covering all of them
  (``batch_economics.py:69``). Per scan the network runs once over the
  batch: ``model.tower`` of the B current clouds and ``model.head``
  against the B cached towers, so the banded kernels launch at batch B.
  The SLAM step then runs for each member, on its own ``SlamState``, with
  the port's Python branches: what JAX's ``vmap`` selects for each member
  (it runs both branches of every ``lax.cond`` and keeps the member's).

Each returns the final states (a list, one per member) and the outputs of
``run_sequence`` / ``run_sequence_fused`` stacked [B, S, ...] as numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from ssf_slam_tpu_torch.config import PipelineConfig
from ssf_slam_tpu_torch.device import resolve_device
from ssf_slam_tpu_torch.engine.fused import run_fused_members
from ssf_slam_tpu_torch.engine.pipeline import (
    init_slam_state,
    run_sequence_scan,
    stack_scans,
)
from ssf_slam_tpu_torch.ops.precision import set_geom_precision


def _stack_members(stacked: list[dict]) -> dict:
    """Per-member numpy dicts [S, ...] -> [B, S, ...]."""
    lengths = {len(next(iter(s.values()))) for s in stacked}
    if len(lengths) != 1:
        raise ValueError(f"sequences of unequal length {sorted(lengths)}")
    return {k: np.stack([s[k] for s in stacked]) for k in stacked[0]}


def run_sequences_batched(frames_batch: list, cfg: PipelineConfig,
                          device: str | torch.device = "cuda"):
    """B sequences (lists of frame dicts of equal length, with the
    variant's ground-truth flow and masks) through the SLAM step: (final
    states, outputs [B, S, ...])."""
    dev = resolve_device(device)
    set_geom_precision()
    scans = _stack_members([stack_scans(seq, cfg) for seq in frames_batch])
    states, outs = [], []
    for b in range(len(frames_batch)):
        member = {k: torch.as_tensor(v[b], device=dev)
                  for k, v in scans.items()}
        state, out = run_sequence_scan(init_slam_state(cfg, dev), member,
                                       cfg)
        states.append(state)
        outs.append(out)
    return states, _stack_members(outs)


def run_sequences_fused_batched(model, frames_batch: list,
                                cfg: PipelineConfig = PipelineConfig(),
                                device: str | torch.device = "cuda",
                                box=None, use_gmm: bool = False):
    """B sequences of equal length through the fused SSF step (SF with
    ``use_gmm``), the network at batch B: (final states, outputs [B, S,
    ...] with those of ``run_sequence_fused``). ``box`` defaults to the
    ``sequence_box`` of all B sequences together; a member run alone
    through ``run_sequence_fused(..., box=box)`` under the same box
    computes what its row here computes. ``model`` must already live on
    ``device``."""
    states, members = run_fused_members(model, frames_batch, cfg, device,
                                        box, use_gmm)
    return states, _stack_members(members)
