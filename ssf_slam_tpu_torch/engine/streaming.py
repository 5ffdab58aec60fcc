"""Online streaming SLAM runner, the live operating mode
(ssf_slam_tpu/engine/streaming.py).

The reference is a live system: scans arrive at 10 Hz
(scripts/PointCloudOdometry.py:42) and the odometry loop polls at the same
rate. ``StreamingRunner`` is the per-arriving-scan host loop:

- one call of the fused step (``engine/fused.py``) per arriving scan, with
  tower caching, so each arrival costs one cloud's pyramid and the head;
- poses come back through a FIFO of ``pipeline_depth`` pending readbacks:
  each scan's ``pose_t || pose_q`` is copied into pinned host memory with
  ``non_blocking=True`` behind a CUDA event, and a scan is retired (its
  event waited on, its TUM line written) once ``pipeline_depth`` scans are
  in flight. Depth 1 is strictly synchronous. The port's step itself syncs
  the host a few times a scan (the keyframe gate, loop detection, the
  Kabsch SVD), which bounds what depth 2 can overlap;
- the TUM trajectory is written incrementally, in arrival order, in the TUM
  order ``t x y z qx qy qz qw`` of ``engine/evaluation.py::write_tum``;
- ``latency_ms_*`` is completion latency (arrival to the pose on the
  host), ``dispatch_ms_*`` the host time to run one step's call, ``hz``
  the sustained rate.

The Morton box cannot cover a sequence that has not arrived yet: it is
anchored at the first scan, padded by ``box_margin`` metres. Points that
leave it clamp to its edge, which costs banded-kNN recall, never a fault;
the runner warns once with the measured overshoot (``box_overshoot``).

``run`` can start from a saved ``SlamState`` (``engine/checkpoint.py``)
and the last scan before it (``prev``): give the fresh runner the first
run's ``box`` so that the towers are sorted as before.
"""

from __future__ import annotations

import collections
import itertools
import sys
import time
from typing import Iterable, Iterator, Optional

import numpy as np
import torch

from ssf_slam_tpu_torch.config import PipelineConfig
from ssf_slam_tpu_torch.device import resolve_device
from ssf_slam_tpu_torch.engine.fused import make_fused_step, sequence_box
from ssf_slam_tpu_torch.ops.precision import set_geom_precision


def box_overshoot(points: np.ndarray, mask: np.ndarray, box) -> float:
    """Max distance (m) any valid point lies outside the Morton box
    (origin [1, 3], scale [1], as ``sequence_box`` builds it); 0.0 when
    every valid point is inside."""
    lo = np.asarray(box[0].cpu() if torch.is_tensor(box[0])
                    else box[0]).reshape(3)
    span = float(np.asarray(box[1].cpu() if torch.is_tensor(box[1])
                            else box[1]).reshape(()))
    p = np.asarray(points, np.float32).reshape(-1, 3)
    m = np.asarray(mask).reshape(-1).astype(bool)
    if not m.any():
        return 0.0
    p = p[m]
    over = np.maximum(lo - p, p - (lo + span))
    return float(max(over.max(), 0.0))


class StreamingRunner:
    """Per-arriving-scan SSF / SF / ssfc pipeline with incremental TUM
    output. ``model`` (and ``seg_apply``'s net) must live on ``device``."""

    def __init__(self, model, cfg: PipelineConfig, use_gmm: bool = False,
                 seg_apply=None, box_margin: float = 100.0,
                 tum_path: Optional[str] = None, pipeline_depth: int = 2,
                 device: str | torch.device = "cuda", box=None):
        self.model = model
        self.cfg = cfg
        self.use_gmm = use_gmm
        self.seg_apply = seg_apply
        self.box_margin = box_margin
        self.tum_path = tum_path
        self.pipeline_depth = max(int(pipeline_depth), 1)
        self.device = resolve_device(device)
        self.box = box  # anchored at the first scan of run() when None
        self.latencies_ms: list[float] = []
        self.final_state = None  # SlamState after run() (map export etc.)

    def _anchor_box(self, first: dict, n: int):
        pts = np.asarray(first["pos1"][:n], np.float32)
        return sequence_box(np.concatenate([pts - self.box_margin,
                                            pts + self.box_margin]),
                            device=self.device)

    def _to_device(self, f: dict, n: int) -> tuple:
        """A frame's (points [n, 3], mask [n], time) on the device."""
        dev = self.device
        return (torch.as_tensor(np.asarray(f["pos1"][:n], np.float32),
                                device=dev),
                torch.as_tensor(np.asarray(f["mask1"][:n]).astype(bool),
                                device=dev),
                torch.tensor(float(f["time"]), dtype=torch.float32,
                             device=dev))

    def _readback(self, outs: dict):
        """Start the copy of pose_t || pose_q to the host: (host tensor,
        CUDA event or None)."""
        pose = torch.cat([outs["pose_t"], outs["pose_q"]])
        if not pose.is_cuda:
            return pose.clone(), None
        host = torch.empty(pose.shape, dtype=pose.dtype, pin_memory=True)
        host.copy_(pose, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def run(self, frames: Iterable[dict], warmup: bool = True,
            state=None, prev: Optional[dict] = None) -> dict:
        """Consume frame dicts ({pos1, mask1, time}); poses stream to
        ``tum_path`` as they retire. Returns the summary stats.

        ``warmup`` runs one throwaway step on the first scan (a live
        deployment builds its kernels before the sensor starts). ``state``
        and ``prev`` resume a run: the step starts from that SlamState, and
        the first scan pairs with ``prev`` (else with itself)."""
        set_geom_precision()
        n = self.cfg.lidar.max_points
        it: Iterator[dict] = iter(frames)
        first = next(it)
        if self.box is None and self.model.cfg.neighbor_backend == "banded":
            self.box = self._anchor_box(first, n)
        box = self.box
        step, make_carry = make_fused_step(self.model, self.cfg, box,
                                           self.use_gmm, self.seg_apply)
        fh = open(self.tum_path, "w") if self.tum_path else None
        prev_pts, prev_mask, _ = self._to_device(prev if prev is not None
                                                 else first, n)

        def scan_of(f):
            """The step's scan dict of frame f at batch 1."""
            pts, mask, t = self._to_device(f, n)
            return dict(points=pts[None], prev=prev_pts[None],
                        mask=mask[None], prev_mask=prev_mask[None],
                        time=t[None])

        pending: collections.deque = collections.deque()
        dispatch_ms: list[float] = []
        n_scans = 0
        warned_box = False

        def retire(entry):
            t_arr, t_scan, host, event = entry
            if event is not None:
                event.synchronize()
            v = host.tolist()  # [x, y, z, qx, qy, qz, qw]
            self.latencies_ms.append((time.perf_counter() - t_arr) * 1e3)
            if fh is not None:
                fh.write(f"{t_scan:.6f} " + " ".join(f"{x:.6f}" for x in v)
                         + "\n")
                fh.flush()

        with torch.inference_mode():
            if warmup:
                _, o = step(make_carry(prev_pts[None]), scan_of(first))
                o[0]["pose_t"].cpu()
                del o
            carry = make_carry(prev_pts[None])
            if state is not None:
                carry = ([state], carry[1])
            t_start = time.perf_counter()
            for f in itertools.chain([first], it):
                t0 = time.perf_counter()
                if box is not None and not warned_box:
                    over = box_overshoot(f["pos1"][:n], f["mask1"][:n], box)
                    if over > 0.0:
                        warned_box = True
                        print(f"WARNING: scan points drifted {over:.1f} m "
                              f"outside the anchored Morton box (box_margin="
                              f"{self.box_margin:.0f} m); banded-kNN recall "
                              "degrades beyond it — raise box_margin to the "
                              "route's expected travel", file=sys.stderr)
                scan = scan_of(f)
                carry, outs = step(carry, scan)
                host, event = self._readback(outs[0])
                dispatch_ms.append((time.perf_counter() - t0) * 1e3)
                prev_pts, prev_mask = scan["points"][0], scan["mask"][0]
                pending.append((t0, float(f["time"]), host, event))
                if len(pending) >= self.pipeline_depth:
                    retire(pending.popleft())
                n_scans += 1
            while pending:
                retire(pending.popleft())
            wall = time.perf_counter() - t_start
        if fh is not None:
            fh.close()
        self.final_state = carry[0][0]

        lat = np.asarray(self.latencies_ms[-n_scans:])
        disp = np.asarray(dispatch_ms)
        return dict(
            n_scans=n_scans,
            hz=n_scans / wall,
            # completion latency: arrival -> pose on the host; at depth > 1
            # it includes the wait behind the scans queued before
            latency_ms_mean=float(lat.mean()),
            latency_ms_p95=float(np.percentile(lat, 95)),
            # the host time of one step's call: the cadence floor
            dispatch_ms_mean=float(disp.mean()),
            dispatch_ms_p95=float(np.percentile(disp, 95)),
            pipeline_depth=self.pipeline_depth,
            n_loops=int(self.final_state.map_state.n_loops_total),
        )
