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

Scale-out across processes. JAX's mesh is one process over many devices;
here it is ``torch.distributed`` with one process per device (NCCL on the
card, gloo on the CPU; neither stands in for the other):

- ``make_mesh``: the process group of this process (under ``torchrun``
  its ``env://`` variables, else a one-process world), as a ``Mesh``;
  ``spawn(fn, world_size, device=...)`` starts ``world_size`` processes on
  one host over a ``FileStore`` in a temporary directory and returns
  ``fn(mesh, *args)`` of each, in rank order;
- ``shard_batch``: this rank's contiguous slice of a host batch;
- ``make_sharded_train_step``: data parallelism, parameters replicated
  and the batch split over the ranks: BatchNorm takes the statistics of
  the global batch (its ``group``) and the gradients are averaged, which
  is the global batch's gradient since the loss is a mean over the batch
  of per-sample sums;
- ``run_sequences_sharded``: one sequence a rank, all gathered into
  [D, S, ...] in rank order; with a model through the fused step under
  one ``sequence_box`` over all D sequences;
- ``run_sequences_sharded_streaming``: the same fed block by block (e.g.
  by ``data/ssfb.py::SsfbStripe``), the box anchored at the first block.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import pickle
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ssf_slam_tpu_torch.config import LossConfig, PipelineConfig, TrainConfig
from ssf_slam_tpu_torch.device import resolve_device
from ssf_slam_tpu_torch.engine.fused import (
    make_fused_step,
    run_fused_members,
    sequence_box,
    stack_fused_scans,
)
from ssf_slam_tpu_torch.engine.pipeline import (
    init_slam_state,
    run_sequence,
    run_sequence_scan,
    stack_outputs,
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


# -- the mesh: one process per device ---------------------------------------

BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


@dataclasses.dataclass
class Mesh:
    """This process's place in the group: its rank, the world size, its
    device and the ``torch.distributed`` process group."""

    rank: int
    world_size: int
    device: torch.device
    group: Any


def _device_of(device, rank: int) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        dev = torch.device("cuda", dev.index if dev.index is not None
                           else local)
        torch.cuda.set_device(dev)
    return dev


def _join(device, index: int, **how) -> None:
    """``init_process_group`` on ``device``'s backend (``how``: the
    rendezvous), bound on CUDA to the card of the rank ``index``."""
    dev = _device_of(device, index)
    dist.init_process_group(BACKENDS[dev.type], **how,
                            **({"device_id": dev} if dev.type == "cuda"
                               else {}))


def make_mesh(n_devices: Optional[int] = None,
              device: str | torch.device = "cuda") -> Mesh:
    """The mesh of this process. Joins the process group first if none is
    initialised: from the ``env://`` variables when ``torchrun`` set them
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT), else as a world of one
    process over a ``FileStore`` in a temporary directory. The backend is
    NCCL for ``cuda`` and gloo for ``cpu``; an initialised group of the
    other backend is an error. ``n_devices``, when given, must equal the
    world size."""
    backend = BACKENDS[torch.device(device).type]
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            _join(device, int(os.environ["RANK"]), init_method="env://")
        else:
            store_dir = tempfile.mkdtemp(prefix="ssf_mesh_")
            _join(device, 0, rank=0, world_size=1, store=dist.FileStore(
                os.path.join(store_dir, "store"), 1))
    if dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                           f"not {backend} for {device}")
    rank, world = dist.get_rank(), dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"mesh of {n_devices} devices asked for in a world "
                         f"of {world} processes")
    return Mesh(rank, world, _device_of(device, rank), dist.group.WORLD)


def _spawn_child(fn, rank, world_size, device, store_path, out_dir, args):
    torch.set_num_threads(1)
    try:
        _join(device, rank, rank=rank, world_size=world_size,
              store=dist.FileStore(store_path, world_size))
        try:
            result = fn(make_mesh(world_size, device), *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as fh:
            pickle.dump(("ok", result), fh)
    except BaseException:
        with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as fh:
            pickle.dump(("error", traceback.format_exc()), fh)
        sys.exit(1)


def spawn(fn: Callable, world_size: int,
          device: str | torch.device = "cuda", args: tuple = (),
          timeout: float = 120.0) -> list:
    """Run ``fn(mesh, *args)`` in ``world_size`` new processes on this host,
    one a rank (one torch thread each), joined over a ``FileStore`` in a
    temporary directory, on the cards unless ``device`` is the CPU. ``fn`` must be importable by name (a module-level
    function) and its result picklable. Returns the results in rank order;
    raises with the failing rank's traceback, or when the processes are
    not all done within ``timeout`` seconds (they are then killed)."""
    device = resolve_device(device)
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="ssf_spawn_")
    try:
        procs = [ctx.Process(target=_spawn_child, daemon=True,
                             args=(fn, r, world_size, device,
                                   os.path.join(tmp, "store"), tmp, args))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results = []
        for r in range(world_size):
            path = os.path.join(tmp, f"{r}.pkl")
            if not os.path.exists(path):
                results.append(("error", f"rank {r} left no result (exit "
                                f"code {procs[r].exitcode})"))
                continue
            with open(path, "rb") as fh:
                results.append(pickle.load(fh))
        if hung:
            raise TimeoutError(f"ranks {hung} still ran after {timeout} s "
                               "and were killed")
        failed = [f"rank {r} failed:\n{value}"
                  for r, (status, value) in enumerate(results)
                  if status != "ok"]
        if failed:  # every rank's: a rank's failure can fail its peers
            raise RuntimeError("\n".join(failed))
        return [value for _, value in results]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's contiguous slice of each key's leading (batch) axis, as
    float32 tensors on the mesh's device; the batch must divide evenly."""
    out = {}
    for k, v in batch.items():
        v = torch.as_tensor(np.asarray(v, np.float32))
        n = v.shape[0]
        if n % mesh.world_size:
            raise ValueError(f"batch of {n} does not split over "
                             f"{mesh.world_size} ranks")
        s = n // mesh.world_size
        out[k] = v[mesh.rank * s:(mesh.rank + 1) * s].to(mesh.device)
    return out


def make_sharded_train_step(model, tx, mesh: Mesh,
                            cfg: TrainConfig = TrainConfig(),
                            loss_cfg: Optional[LossConfig] = None):
    """``step_fn(state, batch) -> (state, metrics)`` with the parameters
    replicated and the batch split over the ranks: ``batch`` is this
    rank's shard (``shard_batch``). Every BatchNorm of ``model`` takes the
    statistics of the global batch (its ``group`` is set to the mesh's),
    the loss is the mean of the ranks' losses and the gradient the mean of
    their gradients, all-reduced; the optimizer then takes the same step on
    every rank, so the parameters stay equal. ``metrics`` are the global
    loss (on the device) and the learning rate."""
    from ssf_slam_tpu_torch.models.layers import BatchNorm
    from ssf_slam_tpu_torch.train.trainer import forward_loss

    del cfg  # the schedule lives in ``tx``
    loss_cfg = loss_cfg or LossConfig()
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = mesh.group

    def step_fn(state, batch: dict):
        model.train(True)
        params = state.params
        loss, _ = forward_loss(model, batch, loss_cfg)
        grads = torch.autograd.grad(loss, list(params.values()))
        flat = torch.cat([g.reshape(-1) for g in grads]
                         + [loss.detach().reshape(1)])
        dist.all_reduce(flat, group=mesh.group)
        flat = flat / mesh.world_size
        mean_grads, at = {}, 0
        for name, g in zip(params, grads):
            mean_grads[name] = flat[at:at + g.numel()].view_as(g)
            at += g.numel()
        lr = tx.lr(state.opt_state.count)
        tx.update(mean_grads, state.opt_state, params)
        state.step += 1
        return state, dict(loss=flat[-1], lr=lr)

    return step_fn


# -- sequences, one a rank ---------------------------------------------------

def _host(obj):
    """A (nested) NamedTuple / list of tensors with the tensors on the
    CPU."""
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_host(x) for x in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host(x) for x in obj)
    return obj


def _gather(obj, mesh: Mesh) -> list:
    """``obj`` of every rank, in rank order."""
    out = [None] * mesh.world_size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def anchored_box(first_points, box_margin: float,
                 device: str | torch.device = "cuda"):
    """The Morton box of a stream: its first block's points ([..., 3], all
    sequences) padded by ``box_margin`` m of travel, as
    ``run_sequences_sharded_streaming`` anchors it."""
    pts = np.asarray(first_points, np.float32).reshape(-1, 3)
    return sequence_box(np.concatenate([pts - box_margin,
                                        pts + box_margin]),
                        device=resolve_device(device))


def run_sequences_sharded(frames_batch: list, cfg: PipelineConfig,
                          mesh: Mesh, model=None, use_gmm: bool = False,
                          box=None):
    """One sequence a rank: every rank is given all D sequences (lists of
    frame dicts of equal length) and runs the one of its rank, with the
    port's Python branches (JAX's ``shard_map`` keeps its ``lax.cond``s as
    real branches too). With ``model`` through the fused SSF step (SF with
    ``use_gmm``), the box on the banded backend being ONE ``sequence_box``
    over all D sequences, the same on every rank (or ``box``, e.g. a
    stream's ``anchored_box``); otherwise through the
    SLAM step on the frames' provided flow (``engine/pipeline.py``).
    ``model`` must already live on the mesh's device. Returns (the D final SlamStates as a list, on the host; outputs
    [D, S, ...] as numpy in rank order), on every rank."""
    if len(frames_batch) != mesh.world_size:
        raise ValueError(f"need exactly one sequence per rank "
                         f"({mesh.world_size}), got {len(frames_batch)}")
    frames = frames_batch[mesh.rank]
    if model is not None:
        if box is None and model.cfg.neighbor_backend == "banded":
            n = cfg.lidar.max_points
            box = sequence_box(np.concatenate(
                [stack_fused_scans(seq, n)["points"].reshape(-1, 3)
                 for seq in frames_batch]), device=mesh.device)
        states, outs = run_fused_members(model, [frames], cfg, mesh.device,
                                         box, use_gmm)
        state, out = states[0], outs[0]
    else:
        state, out = run_sequence(frames, cfg, device=mesh.device)
    outs = _gather(out, mesh)
    return _gather(_host(state), mesh), _stack_members(outs)


def run_sequences_sharded_streaming(batches, cfg: PipelineConfig,
                                    mesh: Mesh, model,
                                    use_gmm: bool = False,
                                    box_margin: float = 100.0,
                                    pipeline_depth: int = 1):
    """The online counterpart of ``run_sequences_sharded``: one fused step
    a rank per arriving block. ``batches`` yields ``(frame_idx, {pos1
    [S, N, 3], mask1 [S, N], time [S, N]})``, as ``SsfbStripe.batches()``
    does: with S equal to the world size each rank takes row ``rank``
    (every rank reads the whole stripe), with S = 1 the block is this
    rank's own stream. The Morton box is anchored at the first block of
    all ranks, padded by ``box_margin`` m (a warning, once, if a later
    block leaves it). ``pipeline_depth`` steps are kept in flight before
    the oldest one's outputs are read back.

    Returns (this rank's final carry, outputs [D, T, ...] as numpy in rank
    order, stats): n_scans, n_seqs, latency_ms_mean / _p95 (arrival to
    outputs on the host), step_ms_mean (the dispatch cadence after the
    first step) and hz_per_seq, measured on this rank."""
    from ssf_slam_tpu_torch.engine.streaming import box_overshoot
    from ssf_slam_tpu_torch.ops.precision import set_geom_precision

    set_geom_precision()
    dev = mesh.device
    it = iter(batches)
    try:
        _, first = next(it)
    except StopIteration:
        raise ValueError("empty stream")
    width = np.asarray(first["pos1"]).shape[0]
    if width not in (1, mesh.world_size):
        raise ValueError(f"stripe width {width} is neither 1 nor the world "
                         f"size {mesh.world_size}")
    row = mesh.rank if width > 1 else 0

    def mine(b):
        return {k: np.asarray(v)[row] for k, v in b.items()}

    block = mine(first)
    box = None
    if model.cfg.neighbor_backend == "banded":
        # every rank's first block, by its exact min and max: the box
        # depends on nothing else
        pts = np.asarray(block["pos1"], np.float32).reshape(-1, 3)
        ext = torch.as_tensor(np.stack([pts.min(0), -pts.max(0)]),
                              device=dev)
        dist.all_reduce(ext, op=dist.ReduceOp.MIN, group=mesh.group)
        ext = ext.cpu().numpy()
        box = anchored_box(np.stack([ext[0], -ext[1]]), box_margin, dev)
    step, make_carry = make_fused_step(model, cfg, box, use_gmm)

    def put(b):
        return (torch.as_tensor(np.asarray(b["pos1"], np.float32),
                                device=dev)[None],
                torch.as_tensor(np.asarray(b["mask1"]) > 0.5,
                                device=dev)[None])

    depth = max(int(pipeline_depth), 1)
    outs_seq, latencies, dispatch_ts = [], [], []
    pending = collections.deque()

    def retire():
        t_arr, outs = pending.popleft()
        outs_seq.append(stack_outputs([outs[0]]))
        latencies.append((time.perf_counter() - t_arr) * 1e3)

    warned_box = False
    prev_pts, prev_mask = put(block)
    with torch.inference_mode():
        carry = make_carry(prev_pts)
        while True:
            t0 = time.perf_counter()
            dispatch_ts.append(t0)
            if box is not None and not warned_box:
                over = box_overshoot(block["pos1"], block["mask1"] > 0.5,
                                     box)
                if over > 0.0:
                    warned_box = True
                    print(f"WARNING: stream points drifted {over:.1f} m "
                          "outside the anchored Morton box (box_margin="
                          f"{box_margin:.0f} m); banded-kNN recall degrades "
                          "beyond it — raise box_margin to the route's "
                          "expected travel", file=sys.stderr)
            pts, mask = put(block)
            scan = dict(points=pts, prev=prev_pts, mask=mask,
                        prev_mask=prev_mask,
                        time=torch.tensor(
                            [float(np.float32(block["time"][0]))],
                            dtype=torch.float32, device=dev))
            carry, outs = step(carry, scan)
            pending.append((t0, outs))
            if len(pending) >= depth:
                retire()
            prev_pts, prev_mask = pts, mask
            try:
                block = mine(next(it)[1])
            except StopIteration:
                break
        while pending:
            retire()

    local = {k: np.concatenate([o[k] for o in outs_seq]) for k in
             outs_seq[0]}
    stacked = _stack_members(_gather(local, mesh))
    lat = np.asarray(latencies[1:] or latencies)  # step 0 builds kernels
    gaps = np.diff(np.asarray(dispatch_ts)) * 1e3
    gaps = gaps[1:] if len(gaps) > 1 else gaps
    step_ms = float(gaps.mean()) if len(gaps) else float(lat.mean())
    stats = dict(n_scans=len(outs_seq), n_seqs=mesh.world_size,
                 latency_ms_mean=float(lat.mean()),
                 latency_ms_p95=float(np.percentile(lat, 95)),
                 step_ms_mean=step_ms,
                 hz_per_seq=float(1e3 / max(step_ms, 1e-9)))
    return carry, stacked, stats
